"""Parity of the port's hierarchical env, policy, multi-head action
distribution, rollout and greedy replay (config 5) with the JAX
package's.

The same seeded numpy inputs go through the jitted JAX functions and the
port. The env runs integer-valued traces (exact in f32) under one
seeded, mask-respecting joint action sequence at JAX's ``TINY_HIER``
width and at config 5's (16 x 8 GPUs in 4 pods, 64-job windows): state,
mask, reward and done must be bit-identical at every step, and the
observations bit-identical outside their tanh-squashed fields, which
stay within 3 f32 ulp of XLA's tanh (an approximation of its own; the
port's is correctly rounded). The sequence must route, place, advance
time on no-ops, force progress and auto-reset. The policy with weights
carried from a JAX ``init`` gives logits and value within 1e-5 at f32
and 5e-2 at bf16; a rollout replaying JAX's actions gives the same
transitions (log-prob and value within 1e-5); a greedy replay gives the
same per-job JCTs. The mechanics cases are JAX's own
(``tests/test_hier.py``), and the CLIs run config 5 at a cut size.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu.algos import action_dist as jdist
from rlgpuschedule_tpu.algos.rollout import init_carry as jinit_carry
from rlgpuschedule_tpu.algos.rollout import rollout as jrollout
from rlgpuschedule_tpu.env import env as jenv
from rlgpuschedule_tpu.env import hier as jhier
from rlgpuschedule_tpu.eval import replay as jreplay
from rlgpuschedule_tpu.models.hier import HierActorCritic as JHier
from rlgpuschedule_tpu.sim import core as jcore
from rlgpuschedule_tpu.traces import gen_poisson_trace as jpoisson
from rlgpuschedule_tpu_torch import eval as teval
from rlgpuschedule_tpu_torch.algos import action_dist as tdist
from rlgpuschedule_tpu_torch.algos.ppo import PPOConfig
from rlgpuschedule_tpu_torch.algos.rollout import init_carry, rollout
from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
from rlgpuschedule_tpu_torch.configs import CONFIGS
from rlgpuschedule_tpu_torch.decision import greedy_actions, preempt_slice
from rlgpuschedule_tpu_torch.env import env as tenv
from rlgpuschedule_tpu_torch.env import hier as thier
from rlgpuschedule_tpu_torch.experiment import (Experiment, build_env_params,
                                                build_hier_params)
from rlgpuschedule_tpu_torch.models import make_hier_policy, params_from_jax
from rlgpuschedule_tpu_torch.sim import core as tcore
from rlgpuschedule_tpu_torch.sim.core import PENDING, RUNNING
from rlgpuschedule_tpu_torch.traces.records import JobRecord, to_array_trace

# the tensors here are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

ULPS = 3   # tanh-squashed observation fields against XLA's
# (n_pods, nodes per pod, gpus per node, max_jobs, queue_len, envs,
#  horizon, steps): JAX's TINY_HIER and config 5's width
GEOMETRIES = {"tiny": (2, 2, 4, 16, 4, 4, 64, 96),
              "config5": (4, 4, 8, 64, 8, 4, 48, 96)}
TINY_HIER = dataclasses.replace(
    CONFIGS["hier-pbt-member"], n_nodes=4, gpus_per_node=4, n_pods=2,
    n_envs=4, window_jobs=16, queue_len=4, horizon=64,
    ppo=PPOConfig(n_steps=8, n_epochs=1, n_minibatches=2))


def _params(P, N, G, J, K, horizon, place_bonus=0.05):
    return (jhier.HierParams(P, jcore.SimParams(N, G, J, K),
                             reward_scale=100.0, place_bonus=place_bonus,
                             horizon=horizon),
            thier.HierParams(P, tcore.SimParams(N, G, J, K),
                             reward_scale=100.0, place_bonus=place_bonus,
                             horizon=horizon))


def _integer_windows(E, J, cap, rate, seed0=0, mean_duration=300.0):
    out = []
    for s in range(E):
        tr = jpoisson(rate, J, seed=seed0 + s, max_jobs=J,
                      mean_duration=mean_duration)
        out.append(dataclasses.replace(
            tr,
            submit=np.where(tr.valid, np.round(tr.submit),
                            np.inf).astype(np.float32),
            duration=np.maximum(np.round(tr.duration), 1.0
                                ).astype(np.float32),
            gpus=np.minimum(tr.gpus, cap).astype(np.int32)))
    return out


def _tanh_fields(params) -> dict:
    P, sp = params.n_pods, params.pod_sim
    top = np.zeros(params.top_obs_dim(), bool)
    top[3 * P + 2:3 * P + 4] = True
    pods = np.zeros(params.obs_shape()["pods"][-1], bool)
    for k in range(sp.queue_len):
        pods[sp.n_nodes + 4 * k + 1:sp.n_nodes + 4 * k + 3] = True
    return {"top": top, "pods": pods}


def _ulps(x, y):
    xi = x.view(np.int32).astype(np.int64)
    yi = y.view(np.int32).astype(np.int64)
    return np.abs(xi - yi)


def _assert_obs(step, params, jobs, tobs):
    for k, fields in _tanh_fields(params).items():
        x, y = np.asarray(jobs[k]), tobs[k].numpy()
        assert x.dtype == y.dtype == np.float32, (step, k)
        u = _ulps(x, y)
        assert u[..., ~fields].max() == 0, (step, k, "outside tanh")
        assert u.max() <= ULPS, (step, k, u.max())


def _assert_state(step, js, ts):
    for name in js.pods._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(js.pods, name)),
            getattr(ts.pods, name).numpy(), err_msg=f"step {step} {name}")
    np.testing.assert_array_equal(np.asarray(js.assignment),
                                  ts.assignment.numpy(), err_msg=str(step))
    np.testing.assert_array_equal(np.asarray(js.t), ts.t.numpy())


def _assert_ts(step, params, jts, tts):
    _assert_obs(step, params, jts.obs, tts.obs)
    for k in ("top", "pods"):
        np.testing.assert_array_equal(np.asarray(jts.action_mask[k]),
                                      tts.action_mask[k].numpy(),
                                      err_msg=f"step {step} mask {k}")
    for f in ("reward", "done"):
        np.testing.assert_array_equal(np.asarray(getattr(jts, f)),
                                      getattr(tts, f).numpy(),
                                      err_msg=f"step {step} {f}")
    for f in jts.info._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jts.info, f)),
                                      getattr(tts.info, f).numpy(),
                                      err_msg=f"step {step} info {f}")


def _joint_actions(rng, mask, idle):
    """A seeded joint action per env: on ``idle`` steps everyone no-ops;
    otherwise the router picks a legal action (and now and then any
    action, a failing route included) and each pod a legal action or
    its no-op."""
    top, pods = mask["top"].numpy(), mask["pods"].numpy()
    E, P, A = pods.shape
    if idle:
        return (np.full(E, P, np.int32), np.full((E, P), A - 1, np.int32))
    t = np.array([rng.choice(np.flatnonzero(r)) if rng.random() < 0.8
                  else rng.integers(0, P + 1) for r in top], np.int32)
    p = np.array([[rng.choice(np.flatnonzero(r)) if rng.random() < 0.6
                   else A - 1 for r in row] for row in pods], np.int32)
    return t, p


# ---- the multi-head action distribution -----------------------------------

def _head_inputs(seed=0, B=6, P=3, A=5):
    rng = np.random.default_rng(seed)
    logits = {"top": rng.normal(size=(B, P + 1)).astype(np.float32),
              "pods": rng.normal(size=(B, P, A)).astype(np.float32)}
    mask = {"top": rng.random((B, P + 1)) < 0.6,
            "pods": rng.random((B, P, A)) < 0.6}
    mask["top"][:, -1] = True
    mask["pods"][..., -1] = True
    logits = {k: np.where(mask[k], v, np.float32(-1e9))
              for k, v in logits.items()}
    actions = {"top": np.array([rng.choice(np.flatnonzero(r))
                                for r in mask["top"]], np.int32),
               "pods": np.array([[rng.choice(np.flatnonzero(r)) for r in row]
                                 for row in mask["pods"]], np.int32)}
    return logits, mask, actions


def test_multi_head_log_prob_and_entropy_match_jax():
    logits, _, actions = _head_inputs()
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    lp = tdist.log_prob(t(logits), t(actions))
    ent = tdist.entropy(t(logits))
    assert lp.shape == ent.shape == (6,)
    np.testing.assert_allclose(lp.numpy(), np.asarray(
        jax.jit(jdist.log_prob)(logits, actions)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ent.numpy(), np.asarray(
        jax.jit(jdist.entropy)(logits)), rtol=0, atol=1e-6)
    # JAX's own hand values: uniform heads
    z = {"top": torch.zeros(5, 3), "pods": torch.zeros(5, 2, 4)}
    a = {"top": torch.zeros(5, dtype=torch.int32),
         "pods": torch.zeros(5, 2, dtype=torch.int32)}
    np.testing.assert_allclose(tdist.log_prob(z, a).numpy(),
                               np.log(1 / 3) + 2 * np.log(1 / 4), rtol=1e-6)
    np.testing.assert_allclose(tdist.entropy(z).numpy(),
                               np.log(3) + 2 * np.log(4), rtol=1e-6)


def test_multi_head_sample_never_picks_a_masked_action():
    logits, mask, _ = _head_inputs(seed=1, B=64)
    t = {k: torch.from_numpy(v) for k, v in logits.items()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        acts, lp = tdist.sample(gen, t)
        assert acts["top"].dtype == acts["pods"].dtype == torch.int32
        assert mask["top"][np.arange(64), acts["top"].numpy()].all()
        assert np.take_along_axis(mask["pods"], acts["pods"].numpy()[..., None],
                                  -1).all()
        np.testing.assert_array_equal(lp.numpy(),
                                      tdist.log_prob(t, acts).numpy())
    # the heads draw from the one generator in key order: top, then pods
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    acts, _ = tdist.sample(g1, t)
    top, _ = tdist.sample(g2, t["top"])
    pods, _ = tdist.sample(g2, t["pods"])
    assert torch.equal(acts["top"], top) and torch.equal(acts["pods"], pods)


def test_single_head_path_is_unchanged():
    """The single-tensor path is the Gumbel-max draw it always was."""
    logits, _, _ = _head_inputs(seed=2)
    lg = torch.from_numpy(logits["top"])
    acts, lp = tdist.sample(torch.Generator().manual_seed(3), lg)
    u = torch.rand(lg.shape, generator=torch.Generator().manual_seed(3))
    want = torch.argmax(lg - torch.log(-torch.log(
        u.clamp_min(torch.finfo(torch.float32).tiny))), -1)
    assert torch.equal(acts, want.to(torch.int32))
    np.testing.assert_array_equal(
        lp.numpy(), torch.log_softmax(lg, -1).gather(
            -1, want[:, None]).squeeze(-1).numpy())
    np.testing.assert_allclose(tdist.entropy(lg).numpy(), np.asarray(
        jax.jit(jdist.entropy)(logits["top"])), rtol=0, atol=1e-6)


def test_greedy_actions_per_head_and_no_stall_gate():
    logits, _, _ = _head_inputs(seed=3)
    t = {k: torch.from_numpy(v) for k, v in logits.items()}
    g = greedy_actions(t)
    want = jax.jit(lambda lg: jax.tree.map(lambda x: jnp.argmax(x, -1), lg)
                   )(logits)
    for k in t:
        np.testing.assert_array_equal(g[k].numpy(), np.asarray(want[k]))
    assert preempt_slice(build_env_params(TINY_HIER)) is None


# ---- the env, bit for bit against JAX --------------------------------------

@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_env_matches_jax_bit_for_bit(geom):
    P, N, G, J, K, E, horizon, steps = GEOMETRIES[geom]
    jp, tp = _params(P, N, G, J, K, horizon)
    wins = _integer_windows(E, J, N * G, rate=0.02 * P)
    # half the envs drain a backlog (every job at t=0): their idle
    # stretches run out of events and force progress
    wins[E // 2:] = [dataclasses.replace(w, submit=np.where(
        w.valid, 0.0, np.inf).astype(np.float32)) for w in wins[E // 2:]]
    jtr = jenv.stack_traces(wins, jp.pod_sim)
    ttr = tenv.stack_traces(wins, tp, device="cpu")
    jreset = jax.jit(lambda tr: jenv.vec_reset(jp, tr))
    jstep = jax.jit(lambda s, tr, a, f: jenv.vec_step(jp, s, tr, a, f))
    js, jts = jreset(jtr)
    ts, tts = thier.vec_reset(tp, ttr)
    _assert_state(-1, js, ts)
    _assert_ts(-1, jp, jts, tts)
    fresh_j, fresh_t = (js, jts), (ts, tts)
    rng = np.random.default_rng(7)
    seen = dict(routed=0, placed=0, advanced=0, forced=0, reset=0)
    for i in range(steps):
        idle = 24 <= i % 48 < 40      # stretches of no-ops: time and force
        top, pods = _joint_actions(rng, tts.action_mask, idle)
        routable = tts.action_mask["top"].numpy()[:, 0]
        js, jts = jstep(js, jtr, {"top": jnp.asarray(top),
                                  "pods": jnp.asarray(pods)}, fresh_j)
        ts, tts = thier.vec_step(tp, ts, ttr, {"top": torch.from_numpy(top),
                                               "pods": torch.from_numpy(pods)},
                                 fresh_t)
        _assert_state(i, js, ts)
        _assert_ts(i, jp, jts, tts)
        info = tts.info
        done = tts.done.numpy()
        routed = (top < P) & routable & ~done
        seen["routed"] += int(routed.sum())
        seen["placed"] += int((info.placed.numpy()
                               & (pods < tp.pod_sim.n_actions - 1).any(1)).sum())
        seen["advanced"] += int((info.dt.numpy() > 0).sum())
        seen["forced"] += int((idle & info.placed.numpy()
                               & (info.dt.numpy() == 0)).sum())
        seen["reset"] += int(done.sum())
    assert all(v > 0 for v in seen.values()), seen


# ---- the mechanics, JAX's hand-checked cases -------------------------------

def _mech(place_bonus=0.0):
    tp = thier.HierParams(2, tcore.SimParams(1, 4, 8, 4), reward_scale=100.0,
                          place_bonus=place_bonus, horizon=64)
    tr = to_array_trace([JobRecord(0, 0.0, 100.0, 2),
                         JobRecord(1, 0.0, 50.0, 2),
                         JobRecord(2, 10.0, 30.0, 2)], max_jobs=8)
    return tp, tenv.stack_traces([tr], tp, device="cpu")


def _act(tp, top=None, pods=None):
    a = {"top": torch.tensor([tp.n_pods if top is None else top],
                             dtype=torch.int32),
         "pods": torch.full((1, tp.n_pods), tp.pod_sim.n_actions - 1,
                            dtype=torch.int32)}
    for p, v in (pods or {}).items():
        a["pods"][0, p] = v
    return a


def test_reset_shapes_and_masks():
    tp, tr = _mech()
    state, ts = thier.reset(tp, tr)
    assert tuple(ts.obs["top"].shape[1:]) == tp.obs_shape()["top"]
    assert tuple(ts.obs["pods"].shape[1:]) == tp.obs_shape()["pods"]
    assert ts.action_mask["top"].shape == (1, tp.n_pods + 1)
    assert bool(ts.action_mask["top"][0, 0]) and \
        bool(ts.action_mask["top"][0, 1])
    assert int(state.assignment[0, 0]) == -1


def test_route_place_and_the_untouched_pod():
    tp, tr = _mech()
    state, _ = thier.reset(tp, tr)
    state, ts = thier.step(tp, state, tr, _act(tp, top=1))
    assert int(state.assignment[0, 0]) == 1        # head = earliest submit
    assert int(state.pods.status[0, 1, 0]) == PENDING
    assert float(ts.info.dt[0]) == 0.0             # routing costs no time
    state, _ = thier.reset(tp, tr)
    state, _ = thier.step(tp, state, tr, _act(tp, top=0))
    state, _ = thier.step(tp, state, tr, _act(tp, pods={0: 0}))
    assert int(state.pods.status[0, 0, 0]) == RUNNING
    assert int(state.pods.free[0, 0].sum()) == tp.pod_capacity - 2
    assert int(state.pods.free[0, 1].sum()) == tp.pod_capacity


def test_place_bonus_shapes_the_reward():
    for bonus, want in ((0.0, 0.0), (0.25, 0.25)):
        tp, tr = _mech(bonus)
        state, _ = thier.reset(tp, tr)
        _, ts = thier.step(tp, state, tr, _act(tp, top=1))
        assert float(ts.reward[0]) == pytest.approx(want)


def test_noop_advances_to_the_next_arrival():
    tp, tr = _mech()
    state, _ = thier.reset(tp, tr)
    state, _ = thier.step(tp, state, tr, _act(tp, top=0))
    state, _ = thier.step(tp, state, tr, _act(tp, pods={0: 0}))
    state, ts = thier.step(tp, state, tr, _act(tp))
    assert float(thier.global_clock(state)[0]) == pytest.approx(10.0)
    assert float(ts.info.dt[0]) == pytest.approx(10.0)
    # -dt * in_system_before / scale: jobs 0 and 1 in the system
    assert float(ts.reward[0]) == pytest.approx(-10.0 * 2 / 100.0)


def test_forced_progress_routes_when_idle():
    tp, tr = _mech()
    state, _ = thier.reset(tp, tr)
    for _ in range(12):
        state, ts = thier.step(tp, state, tr, _act(tp))
    assert int((state.assignment >= 0).sum()) == 3
    assert bool(ts.done[0]) or int((state.pods.status == RUNNING).sum()) > 0


def test_episode_completes_with_the_hand_checked_jct():
    """Route both t=0 jobs to different pods and place at once: job 2
    (t=10, 30 s) finishes at 40. JCTs 100, 50 and 30."""
    tp, tr = _mech()
    state, ts = thier.reset(tp, tr)
    for _ in range(40):
        mask = ts.action_mask
        pod_free = state.pods.free.sum(2)[0]
        top = (int(torch.argmax(pod_free)) if bool(mask["top"][0, :2].any())
               else tp.n_pods)
        a = _act(tp, top=top, pods={p: 0 for p in range(2)
                                    if bool(mask["pods"][0, p, 0])})
        state, ts = thier.step(tp, state, tr, a)
        if bool(ts.done[0]):
            break
    assert bool(ts.done[0])
    stats = thier.jct_stats(state, tr)
    assert int(stats["n_done"][0]) == 3
    np.testing.assert_allclose(float(stats["avg_jct"][0]),
                               (100 + 50 + 30) / 3, rtol=1e-5)


def test_oversized_job_refused_at_validation():
    tp, _ = _mech()
    big = to_array_trace([JobRecord(0, 0.0, 10.0, 8)], max_jobs=4)
    with pytest.raises(ValueError):
        thier.validate_hier_trace(tp, big)
    with pytest.raises(ValueError):
        tenv.stack_traces([big], tp, device="cpu")


def test_build_refuses_what_jax_refuses():
    bad = {"n_nodes": 6, "n_pods": 4}
    with pytest.raises(ValueError, match="not divisible by n_pods"):
        build_hier_params(dataclasses.replace(TINY_HIER, **bad))
    with pytest.raises(ValueError, match="flat pod observations"):
        build_hier_params(dataclasses.replace(TINY_HIER, obs_kind="grid"))
    with pytest.raises(ValueError, match="preemptive action space"):
        build_hier_params(dataclasses.replace(TINY_HIER, preempt_len=2))


# ---- the policy and the rollout --------------------------------------------

@pytest.fixture(scope="module")
def world():
    """JAX's hierarchical policy at TINY_HIER's width, its f32 weights,
    the port's copy, and a JAX rollout of 8 steps on integer traces."""
    tp = build_hier_params(TINY_HIER)
    jp = jhier.HierParams(tp.n_pods, jcore.SimParams(
        tp.pod_sim.n_nodes, tp.pod_sim.gpus_per_node, tp.pod_sim.max_jobs,
        tp.pod_sim.queue_len), tp.time_scale, tp.reward_scale,
        tp.place_bonus, tp.horizon)
    wins = _integer_windows(4, 16, tp.pod_capacity, rate=0.04, seed0=11)
    jtr = jenv.stack_traces(wins, jp.pod_sim)
    ttr = tenv.stack_traces(wins, tp, device="cpu")
    jnet = JHier(n_top_actions=tp.n_top_actions,
                 n_pod_actions=tp.pod_sim.n_actions, dtype=jnp.float32)
    carry = jax.jit(lambda tr, k: jinit_carry(jp, tr, k))(
        jtr, jax.random.PRNGKey(3))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), carry.obs,
                                carry.mask)
    # a policy head scaled up from its 0.01-gain init, so the actions it
    # samples (and the greedy replay) depend on the weights
    params = jax.device_get(params)
    for head in ("top_policy", "pod_policy"):
        k = params["params"][head]["kernel"]
        params["params"][head]["kernel"] = np.asarray(k) * np.float32(300)
    apply = lambda p, o, m: jnet.apply(p, o, m)
    # the traces go in as an argument, not a constant, so both parity
    # files' rollouts are one program in the persistent compile cache
    _, jtrans, jlast = jax.jit(
        lambda p, c, tr: jrollout(apply, p, jp, tr, c, 8))(params, carry,
                                                             jtr)
    tnet = make_hier_policy(tp, dtype=torch.float32, device="cpu")
    tnet.load_state_dict(params_from_jax(params))
    return dataclasses.make_dataclass("W", [
        "tp", "jp", "wins", "jtr", "ttr", "jnet", "params", "tnet",
        "jtrans", "jlast"])(tp, jp, wins, jtr, ttr, jnet, params, tnet,
                            jax.device_get(jtrans), np.asarray(jlast))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_policy_matches_jax(world, dtype, tol):
    jnet = JHier(n_top_actions=world.tp.n_top_actions,
                 n_pod_actions=world.tp.pod_sim.n_actions,
                 dtype=getattr(jnp, dtype))
    obs = jax.tree.map(lambda x: x[0], world.jtrans.obs)
    mask = jax.tree.map(lambda x: x[0], world.jtrans.mask)
    jl, jv = jax.jit(jnet.apply)(world.params, obs, mask)
    tnet = make_hier_policy(world.tp, dtype=getattr(torch, dtype),
                            device="cpu")
    tnet.load_state_dict(params_from_jax(world.params))
    with torch.no_grad():
        tl, tv = tnet({k: torch.tensor(np.asarray(v))
                       for k, v in obs.items()},
                      {k: torch.tensor(np.asarray(v))
                       for k, v in mask.items()})
    assert set(tl) == {"top", "pods"} and tv.dtype == torch.float32
    for k in tl:
        assert tl[k].dtype == torch.float32
        legal = np.asarray(mask[k])
        assert np.abs(np.asarray(jl[k])[legal]).max() > 10 * tol
        np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                   rtol=tol, atol=tol, err_msg=k)
        np.testing.assert_array_equal(tl[k].numpy()[~legal],
                                      np.float32(-1e9))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=tol,
                               atol=tol)


def test_rollout_replaying_jax_actions_matches(world):
    acts = world.jtrans.action
    steps = iter(range(8))

    def replay(gen, logits):
        i = next(steps)
        a = {k: torch.tensor(np.asarray(v[i])) for k, v in acts.items()}
        return a, tdist.log_prob(logits, a)

    carry = init_carry(world.tp, world.ttr, torch.Generator())
    _, tr, last = rollout(world.tnet, world.tp, world.ttr, carry, 8,
                          sample_fn=replay)
    j = world.jtrans
    for t in range(8):
        _assert_obs(t, world.tp, jax.tree.map(lambda x: x[t], j.obs),
                    {k: v[t] for k, v in tr.obs.items()})
    for k in ("top", "pods"):
        np.testing.assert_array_equal(np.asarray(j.mask[k]),
                                      tr.mask[k].numpy())
        np.testing.assert_array_equal(np.asarray(j.action[k]),
                                      tr.action[k].numpy())
    for f in ("reward", "done", "env_steps_dt"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(tr, f).numpy(), err_msg=f)
    for f in ("log_prob", "value"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    np.testing.assert_allclose(last.numpy(), world.jlast, rtol=1e-5,
                               atol=1e-5)
    assert np.asarray(j.reward).any()


def test_greedy_replay_matches_jax_job_for_job(world):
    apply = lambda p, o, m: world.jnet.apply(p, o, m)
    jres, jstate = jax.jit(lambda p: jreplay(
        apply, p, world.jp, world.jtr, return_states=True))(world.params)
    tres, tstate = teval.replay(world.tnet, world.tp, world.ttr,
                                return_states=True)
    for f in ("n_done", "n_valid", "steps"):
        np.testing.assert_array_equal(np.asarray(getattr(jres, f)),
                                      getattr(tres, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(jres.makespan),
                                  tres.makespan.numpy())
    jfin = np.asarray(jstate.pods.finish).min(1)
    np.testing.assert_array_equal(jfin, tstate.pods.finish.amin(1).numpy())
    np.testing.assert_allclose(tres.avg_jct.numpy(), np.asarray(jres.avg_jct),
                               rtol=1e-6)
    np.testing.assert_allclose(tres.utilization.numpy(),
                               np.asarray(jres.utilization), rtol=1e-6)
    assert tres.n_done.sum() > 0


# ---- a single hierarchical Experiment, its report and its CLIs -------------

def test_experiment_trains_resumes_and_reports(tmp_path):
    exp = Experiment.build(TINY_HIER, device="cpu")
    out = exp.run(2, log_every=1)
    assert out["env_steps"] == 2 * 8 * 4
    assert all(np.isfinite(h["total_loss"]) for h in out["history"])
    with Checkpointer(str(tmp_path / "ck")) as ck:
        exp.save_checkpoint(ck)
        exp.run(2)
        again = Experiment.build(TINY_HIER, device="cpu")
        again.restore_checkpoint(ck)
    again.run(2)
    for a, b in zip(exp.net.parameters(), again.net.parameters()):
        assert torch.equal(a, b)
    for k in ("obs", "mask"):
        for h in ("top", "pods"):
            assert torch.equal(getattr(exp.carry, k)[h],
                               getattr(again.carry, k)[h])
    report = teval.jct_report(exp)
    for k in ("policy", "random", "fifo", "sjf", "srtf", "tiresias",
              "vs_tiresias"):
        assert np.isfinite(report[k]), k
    assert "stall_guard" not in report
    with pytest.raises(ValueError, match="flat configs"):
        teval.jct_report(exp, percentiles=(50,))
    with pytest.raises(ValueError, match="flat configs"):
        teval.replay(exp.net, exp.env_params, exp.traces, backlog_gate=2)
    with pytest.raises(ValueError, match="flat configs"):
        teval.full_trace_report(exp)
    with pytest.raises(ValueError, match="flat configs"):
        teval.fairness_report(exp)


CUT = ["--config", "hier-pbt-member", "--n-steps", "8", "--n-epochs", "1",
       "--n-minibatches", "2", "--device", "cpu"]


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def test_train_evaluate_and_serve_clis_run_config_5(tmp_path, capsys):
    from rlgpuschedule_tpu_torch import evaluate, train
    from rlgpuschedule_tpu_torch.serve import __main__ as serve
    d = str(tmp_path / "run")
    summary = train.main(CUT + ["--iterations", "2", "--log-every", "1",
                                "--ckpt-dir", d, "--report"])
    assert summary["env_steps"] == 2 * 8 * 4
    assert np.isfinite(summary["jct_report"]["policy"])
    report = evaluate.main(["--config", "hier-pbt-member", "--ckpt-dir", d,
                            "--device", "cpu", "--no-random"])
    assert report["policy_completion"] > 0
    assert np.isfinite(report["vs_tiresias"])
    capsys.readouterr()
    out = serve.main(["--config", "hier-pbt-member", "--fleet", "2",
                      "--ckpt-dir", d, "--device", "cpu"])
    assert out["fleet"]["n_clusters"] == 2
    assert out["fleet"]["completion"] > 0
    # config 5 is served through one engine; a router of it is refused
    # in the mode table's words, as JAX refuses it
    out = serve.main(["--config", "hier-pbt-member", "--bench", "--ckpt-dir",
                      d, "--n-envs", "2", "--pool-steps", "1", "--rounds",
                      "3", "--device", "cpu"])
    assert out["bench"]["requests"] > 0
    assert out["bench"]["post_warmup_recompiles"] == 0
    with pytest.raises(SystemExit, match="unsupported mode combination"):
        serve.main(["--config", "hier-pbt-member", "--bench", "--engines",
                    "2", "--device", "cpu"])
    for argv, msg in (
            (["--full-trace"], "full-trace evaluation supports flat"),
            (["--fairness"], "fairness_report supports flat"),
            (["--percentiles"], "percentiles are supported for flat"),
            (["--backlog-gate", "2"], "no single FIFO fall-through"),
            (["--no-stall-guard"], "PREEMPTIVE")):
        with pytest.raises(SystemExit, match=msg):
            evaluate.main(["--config", "hier-pbt-member", "--device", "cpu"]
                          + argv)
    with pytest.raises(SystemExit, match="--correction vtrace"):
        train.main(CUT + ["--correction", "vtrace"])
