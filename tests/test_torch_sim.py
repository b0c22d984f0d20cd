"""Parity of the port's simulator and env step with the JAX package.

The same action sequences go through both packages' env step at a small
size: random legal actions from a numpy seed, then a run of the JAX
greedy policy's actions. On integer-valued traces the sim state, the
step info, the mask and the reward must be bit-identical at every step
(the contract ``tests/test_sim_core.py`` holds the JAX simulator to
against the oracle); on float Philly-proxy windows the integer fields
and the mask must be identical and the f32 fields within 2 ulp.
Observations are held to rtol 1e-6 / atol 1e-7 (tanh differs by an ulp
between XLA and torch).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu.env import env as jenv
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu.sim import core as jcore
from rlgpuschedule_tpu.traces import gen_philly_proxy_trace as jphilly
from rlgpuschedule_tpu.traces import gen_poisson_trace as jpoisson
from rlgpuschedule_tpu_torch.env import env as tenv
from rlgpuschedule_tpu_torch.sim import core as tcore

# the tensors here are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

N, G, J, K, E = 8, 4, 32, 4, 4
STEPS = 96


def _integer_windows():
    out = []
    for s in range(E):
        tr = jpoisson(0.05, J, seed=s, max_jobs=J, mean_duration=300.0)
        out.append(dataclasses.replace(
            tr,
            submit=np.where(tr.valid, np.round(tr.submit),
                            np.inf).astype(np.float32),
            duration=np.maximum(np.round(tr.duration), 1.0
                                ).astype(np.float32)))
    return out


def _proxy_windows():
    src = jphilly(E * J, seed=3, n_gpus=N * G, load=1.3, max_gang=N * G)
    return [src.slice(e * J, J) for e in range(E)]


def _params(kind):
    kw = dict(obs_kind=kind, horizon=STEPS + 8, place_bonus=0.05,
              reward_scale=1e4, time_scale=600.0)
    return (jenv.EnvParams(sim=jcore.SimParams(N, G, J, K), **kw),
            tenv.EnvParams(sim=tcore.SimParams(N, G, J, K), **kw))


def _ulps(x, y):
    """Distance in f32 ulps (equal infinities count 0)."""
    xi = x.view(np.int32).astype(np.int64)
    yi = y.view(np.int32).astype(np.int64)
    xi = np.where(xi < 0, np.int64(-2**31) - xi, xi)
    yi = np.where(yi < 0, np.int64(-2**31) - yi, yi)
    return np.where(x == y, 0, np.abs(xi - yi))


def _check(step, jst, jts, tst, tts, exact):
    for name in jst.sim._fields:
        x = np.asarray(getattr(jst.sim, name))
        y = getattr(tst.sim, name).numpy()
        assert x.dtype == y.dtype, (step, name, x.dtype, y.dtype)
        if exact or x.dtype != np.float32:
            np.testing.assert_array_equal(x, y, err_msg=f"step {step} {name}")
        else:
            assert _ulps(x, y).max() <= 2, (step, name, _ulps(x, y).max())
    for name in jts.info._fields:
        x = np.asarray(getattr(jts.info, name))
        y = getattr(tts.info, name).numpy()
        assert x.dtype == y.dtype, (step, name)
        if exact or x.dtype != np.float32:
            np.testing.assert_array_equal(x, y, err_msg=f"step {step} {name}")
        else:
            assert _ulps(x, y).max() <= 2, (step, name)
    np.testing.assert_array_equal(np.asarray(jst.t), tst.t.numpy())
    np.testing.assert_array_equal(np.asarray(jts.action_mask),
                                  tts.action_mask.numpy())
    np.testing.assert_array_equal(np.asarray(jts.done), tts.done.numpy())
    r_j, r_t = np.asarray(jts.reward), tts.reward.numpy()
    if exact:
        np.testing.assert_array_equal(r_j, r_t, err_msg=f"step {step}")
    else:
        assert _ulps(r_j, r_t).max() <= 2, step
    np.testing.assert_allclose(tts.obs.numpy(), np.asarray(jts.obs),
                               rtol=1e-6, atol=1e-7,
                               err_msg=f"step {step} obs")


@pytest.mark.parametrize("kind", ["flat", "grid"])
@pytest.mark.parametrize("windows", ["integer", "proxy"])
def test_env_step_matches_jax(kind, windows):
    jp, tp = _params(kind)
    wins = _integer_windows() if windows == "integer" else _proxy_windows()
    jtr = jenv.stack_traces(wins, jp)
    ttr = tenv.stack_traces(wins, tp, device="cpu")
    exact = windows == "integer"
    jst, jts = jax.jit(lambda tr: jenv.vec_reset(jp, tr))(jtr)
    tst, tts = tenv.vec_reset(tp, ttr)
    _check(-1, jst, jts, tst, tts, exact)
    step = jax.jit(jax.vmap(lambda s, tr, a: jenv.step(jp, s, tr, a)))
    net = jmake_policy(kind, jp.n_actions, dtype=jnp.float32)
    params = jax.jit(net.init)(jax.random.PRNGKey(0), jts.obs,
                               jts.action_mask)
    greedy = jax.jit(lambda o, m: jnp.argmax(net.apply(params, o, m)[0], -1))
    rng = np.random.default_rng(7)
    placed = 0
    for i in range(STEPS):
        if i < STEPS // 2:
            m = np.asarray(jts.action_mask)
            a = np.array([rng.choice(np.flatnonzero(r)) for r in m],
                         np.int32)
        else:
            a = np.asarray(greedy(jts.obs, jts.action_mask), np.int32)
        jst, jts = step(jst, jtr, jnp.asarray(a))
        tst, tts = tenv.step(tp, tst, ttr, torch.from_numpy(a))
        _check(i, jst, jts, tst, tts, exact)
        placed += int(np.asarray(jts.info.placed).sum())
    assert placed > E, "the action sequences placed almost nothing"


def test_vec_step_auto_resets_like_jax():
    jp, tp = _params("flat")
    jp = dataclasses.replace(jp, horizon=5)
    tp = dataclasses.replace(tp, horizon=5)
    wins = _integer_windows()
    jtr = jenv.stack_traces(wins, jp)
    ttr = tenv.stack_traces(wins, tp, device="cpu")
    jst, jts = jax.jit(lambda tr: jenv.vec_reset(jp, tr))(jtr)
    tst, tts = tenv.vec_reset(tp, ttr)
    # jitted, as every caller of the reference runs it: XLA turns the
    # reward's division by a constant into a multiplication
    jstep = jax.jit(lambda s, tr, a: jenv.vec_step(jp, s, tr, a))
    a = np.full(E, K, np.int32)    # no-op: advance to the next event
    for i in range(7):
        jst, jts = jstep(jst, jtr, jnp.asarray(a))
        tst, tts = tenv.vec_step(tp, tst, ttr, torch.from_numpy(a))
        _check(i, jst, jts, tst, tts, exact=True)
    assert np.asarray(jst.t).max() < 5     # episodes did restart


def _state(free, status=None):
    """A one-node-row SimState stub for the placement and queue tests."""
    free = torch.tensor(free, dtype=torch.int32)
    E_, N_ = free.shape
    st = torch.tensor(status, dtype=torch.int32) if status is not None \
        else torch.zeros(E_, 6, dtype=torch.int32)
    J_ = st.shape[1]
    z = torch.zeros(E_, J_)
    return tcore.SimState(torch.zeros(E_), st, z, z, z,
                          torch.zeros(E_, J_, N_, dtype=torch.int32), free)


def test_pack_placement_ties_go_to_lowest_node_like_jax():
    # many equal free counts: only a stable sort gives the oracle's
    # (free desc, id asc) order
    rng = np.random.default_rng(0)
    free = rng.integers(0, 3, size=(64, 24)).astype(np.int32)
    demand = rng.integers(1, 20, size=64).astype(np.int32)
    ja, jf = jax.jit(jax.vmap(jcore.pack_placement))(jnp.asarray(free),
                                             jnp.asarray(demand))
    ta, tf = tcore.pack_placement(torch.from_numpy(free),
                                  torch.from_numpy(demand))
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    assert ta.dtype == torch.int32


def test_pending_queue_drop_slot_like_jax():
    rng = np.random.default_rng(1)
    status = rng.integers(0, 4, size=(16, 40)).astype(np.int32)
    status[0] = tcore.PENDING          # more pending rows than slots
    status[1] = tcore.DONE             # none
    sp_j, sp_t = jcore.SimParams(2, 2, 40, 6), tcore.SimParams(2, 2, 40, 6)
    st = _state(np.zeros((16, 2), np.int32), status)
    got = tcore.pending_queue(sp_t, st)
    want = jax.jit(jax.vmap(lambda s: jcore.pending_queue(
        sp_j, jcore.SimState(*[jnp.zeros(())] + [s] + [jnp.zeros(())] * 5
                             ))))(jnp.asarray(status))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got.dtype == torch.int32


def test_completion_tolerance_is_nan_at_infinity_like_jnp_spacing():
    t = torch.tensor([0.0, 1.0, 3.0e6, float("inf")])
    want = np.asarray(jnp.spacing(jnp.asarray(t.numpy())))
    got = tcore._spacing(t).numpy()
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(want[ok], got[ok])


def test_advance_at_philly_clock_does_not_complete_early():
    # at t ~ 3e6 s one f32 ulp is 0.25 s: a job 2 s from done must stay
    # RUNNING when the clock advances to an earlier arrival
    sp = tcore.SimParams(1, 8, 2, 2)
    tr = tcore.Trace(torch.tensor([[0.0, 3.0e6]]), torch.ones(1, 2),
                     torch.ones(1, 2, dtype=torch.int32),
                     torch.zeros(1, 2, dtype=torch.int32),
                     torch.ones(1, 2, dtype=torch.bool))
    st = tcore.init_state(sp, tr)
    st = st._replace(clock=torch.tensor([3.0e6 - 100.0]),
                     status=torch.tensor([[tcore.RUNNING, 0]],
                                         dtype=torch.int32),
                     remaining=torch.tensor([[102.0, 1.0]]))
    out = tcore.advance_to(st, tr, torch.tensor([3.0e6]))
    assert int(out.status[0, 0]) == tcore.RUNNING
    assert int(out.status[0, 1]) == tcore.PENDING
    assert float(out.remaining[0, 0]) == 2.0


@pytest.mark.parametrize("name", ["hier-pbt-member", "a2c-pai-fair"])
def test_configs_outside_the_slice_are_refused(name):
    """Both presets build as published (config 5 as the hierarchical
    env); what the hierarchical env cannot run is refused in JAX's
    words: config 3 made hierarchical (the fairness reward) and config 5
    on the grid observation."""
    import dataclasses
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.env.hier import HierParams
    from rlgpuschedule_tpu_torch.experiment import build_env_params
    cfg = CONFIGS[name]
    bad = (dataclasses.replace(cfg, n_pods=4) if name == "a2c-pai-fair"
           else dataclasses.replace(cfg, obs_kind="grid"))
    with pytest.raises(ValueError, match="flat pod observations and the "
                                         "JCT reward"):
        build_env_params(bad)
    params = build_env_params(cfg)
    if name == "a2c-pai-fair":
        assert (params.reward_kind, params.n_tenants) == ("fair", 8)
    else:
        assert isinstance(params, HierParams)
        assert (params.n_pods, params.pod_sim.n_nodes) == (4, 4)


@pytest.mark.parametrize("name", ["gnn-gang-place", "ppo-mlp-preempt"])
def test_preemptive_and_graph_presets_build_like_jax(name):
    """The two presets build at their published widths, with the JAX
    package's action and observation layout, preempt charge and (for
    the graph) adjacency."""
    from rlgpuschedule_tpu.configs import CONFIGS as JCONFIGS
    from rlgpuschedule_tpu.env.obs import build_adjacency
    from rlgpuschedule_tpu.experiment import build_env_params as jbuild
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.experiment import (build_env_params,
                                                    build_policy)
    cfg, ref = CONFIGS[name], JCONFIGS[name]
    for f in ("n_nodes", "gpus_per_node", "queue_len", "n_placements",
              "preempt_len", "obs_kind", "window_jobs", "nodes_per_rack",
              "preempt_cost", "horizon", "n_envs"):
        assert getattr(cfg, f) == getattr(ref, f), f
    tp, jp = build_env_params(cfg), jbuild(ref)
    assert tp.n_actions == jp.n_actions and tp.obs_shape() == jp.obs_shape()
    assert (tp.preempt_cost, tp.sim) == (jp.preempt_cost, tcore.SimParams(
        **dataclasses.asdict(jp.sim)))
    net = build_policy(cfg, tp, device="cpu")
    if cfg.obs_kind == "graph":
        adj = build_adjacency(cfg.n_nodes, cfg.queue_len,
                              cfg.nodes_per_rack,
                              cfg.preempt_len).astype(np.float32)
        a_norm = adj / np.maximum(adj.sum(-1, keepdims=True), 1.0)
        # held in the trunk dtype, rounded once from f32 as Flax rounds it
        assert torch.equal(net.a_norm,
                           torch.from_numpy(a_norm).to(net.a_norm.dtype))
    from rlgpuschedule_tpu_torch.serve.fleet import fleet_windows
    _, traces = fleet_windows(cfg, 2, device="cpu")
    _, ts = tenv.reset(tp, traces)
    assert tuple(ts.obs.shape) == (2,) + tp.obs_shape()
    with torch.no_grad():
        logits, value = net(ts.obs, ts.action_mask)
    assert tuple(logits.shape) == (2, tp.n_actions)
    assert torch.isfinite(value).all()


def test_trace_upload_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tenv.stack_traces(_integer_windows(), _params("flat")[1])
