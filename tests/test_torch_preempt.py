"""Parity of the port's preemptive and pack|spread action spaces with the
JAX package's simulator, env and stall gate, and with ``OracleSim``.

Integer-valued traces (exact in f32) go through three simulators under
the same action sequences, for (P, R) = (2, 0), (1, 4) and (2, 4): the
port's batched ``rl_step``, the JAX package's jitted ``rl_step`` and the
port's ``OracleSim``, one per cluster. The sim state and the step info
must be bit-identical to JAX's at every step, and equal to the oracle's
(f32 against the oracle's f64, exact on these traces; the oracle's NaN
start/finish read as +inf). The env steps of the flat and the grid
observation with R = 4 and of the graph observation (P = 2, R = 0 and
R = 4) must give a bit-identical mask, reward and done and an
observation bit-identical outside the tanh-squashed fields, which stay
within 3 f32 ulp of XLA's (its tanh is its own approximation).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu import decision as jdecision
from rlgpuschedule_tpu.env import env as jenv
from rlgpuschedule_tpu.env import obs as jobs
from rlgpuschedule_tpu.sim import core as jcore
from rlgpuschedule_tpu.traces import gen_poisson_trace as jpoisson
from rlgpuschedule_tpu_torch import decision as tdecision
from rlgpuschedule_tpu_torch.env import env as tenv
from rlgpuschedule_tpu_torch.env import obs as tobs
from rlgpuschedule_tpu_torch.env import rewards as trewards
from rlgpuschedule_tpu_torch.sim import core as tcore
from rlgpuschedule_tpu_torch.sim.oracle import OracleSim

# the tensors here are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

N, G, J, K, E = 4, 4, 32, 4, 4
STEPS = 64
ULPS = 3      # tanh-squashed observation fields against XLA's


def _integer_windows(rate=0.05, mean_duration=300.0):
    out = []
    for s in range(E):
        tr = jpoisson(rate, J, seed=s, max_jobs=J,
                      mean_duration=mean_duration)
        out.append(dataclasses.replace(
            tr,
            submit=np.where(tr.valid, np.round(tr.submit),
                            np.inf).astype(np.float32),
            duration=np.maximum(np.round(tr.duration), 1.0
                                ).astype(np.float32),
            gpus=np.minimum(tr.gpus, N * G).astype(np.int32)))
    return out


def _sims(P, R):
    return (jcore.SimParams(N, G, J, K, n_placements=P, preempt_len=R),
            tcore.SimParams(N, G, J, K, n_placements=P, preempt_len=R))


def _actions(rng, mask):
    """Half the clusters' actions uniform over every action (invalid and
    infeasible ones included), the rest uniform over the legal ones."""
    out = []
    for row in mask:
        if rng.random() < 0.5:
            out.append(rng.integers(0, row.size))
        else:
            out.append(rng.choice(np.flatnonzero(row)))
    return np.array(out, np.int32)


def _assert_state_equal(step, jst, tst):
    for name in jst._fields:
        x = np.asarray(getattr(jst, name))
        y = getattr(tst, name).numpy()
        assert x.dtype == y.dtype, (step, name)
        np.testing.assert_array_equal(x, y, err_msg=f"step {step} {name}")


def _assert_oracle_equal(step, e, osim, tst):
    ctx = f"step {step} cluster {e}"
    f32 = lambda x: np.where(np.isnan(x), np.inf, x).astype(np.float32)
    assert np.float32(osim.clock) == tst.clock[e].item(), ctx
    for name in ("status", "alloc", "free"):
        np.testing.assert_array_equal(getattr(tst, name)[e].numpy(),
                                      getattr(osim, name), err_msg=ctx)
    for name in ("remaining", "start", "finish"):
        np.testing.assert_array_equal(getattr(tst, name)[e].numpy(),
                                      f32(getattr(osim, name)),
                                      err_msg=f"{ctx} {name}")


@pytest.mark.parametrize("P,R", [(2, 0), (1, 4), (2, 4)])
def test_rl_step_matches_jax_and_the_oracle(P, R):
    jsp, tsp = _sims(P, R)
    wins = _integer_windows(rate=0.08, mean_duration=600.0)
    jtr = jenv.stack_traces(wins, jsp)
    ttr = tenv.stack_traces(wins, tsp, device="cpu")
    jstate = jax.jit(jax.vmap(lambda tr: jcore.init_state(jsp, tr)))(jtr)
    tstate = tcore.init_state(tsp, ttr)
    jstep = jax.jit(jax.vmap(lambda s, tr, a: jcore.rl_step(jsp, s, tr, a)))
    jmask = jax.jit(jax.vmap(lambda s, tr: jcore.action_mask(jsp, s, tr)))
    oracles = [OracleSim(w, N, G) for w in wins]
    rng = np.random.default_rng(10 * P + R)
    counts = {"spread": 0, "preempted": 0, "replaced": 0}
    for i in range(STEPS):
        mask = tcore.action_mask(tsp, tstate, ttr).numpy()
        np.testing.assert_array_equal(
            np.asarray(jmask(jstate, jtr)), mask, err_msg=f"step {i}")
        a = _actions(rng, mask)
        jstate, jinfo = jstep(jstate, jtr, jnp.asarray(a))
        tstate, tinfo = tcore.rl_step(tsp, tstate, ttr, torch.from_numpy(a))
        _assert_state_equal(i, jstate, tstate)
        _assert_state_equal(i, jinfo, tinfo)
        for e, osim in enumerate(oracles):
            oinfo = osim.rl_step(int(a[e]), K, P, R)
            _assert_oracle_equal(i, e, osim, tstate)
            for k, v in oinfo.items():
                assert getattr(tinfo, k)[e].item() == v, (i, e, k)
        placed = tinfo.placed.numpy()
        counts["spread"] += int((placed & (a < K * P) & (a % P == 1)).sum())
        counts["preempted"] += int(tinfo.preempted.sum())
        counts["replaced"] += int((placed & ~tinfo.first_placed.numpy())
                                  .sum())
    if P == 2:
        assert counts["spread"] > 0, counts
    if R:
        assert counts["preempted"] > 0 and counts["replaced"] > 0, counts


def test_spread_placement_matches_jax_and_the_oracle():
    from rlgpuschedule_tpu_torch.sim.oracle import spread_placement
    rng = np.random.default_rng(0)
    free = rng.integers(0, 9, size=(200, 6)).astype(np.int32)
    demand = rng.integers(1, 30, size=200).astype(np.int32)
    ja, jf = jax.jit(jax.vmap(lambda f, d: jcore.spread_placement(f, d, 8)))(
        jnp.asarray(free), jnp.asarray(demand))
    ta, tf = tcore.spread_placement(torch.from_numpy(free),
                                    torch.from_numpy(demand), 8)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    assert ta.dtype == torch.int32 and tf.any() and not tf.all()
    for f, d, a, ok in zip(free, demand, ta.numpy(), tf.numpy()):
        want = spread_placement(f, int(d))
        assert ok == (want is not None)
        if ok:
            np.testing.assert_array_equal(a, want)


def _one(jobs, n_nodes, gpus, max_jobs, **kw):
    """A one-cluster port trace and its SimParams from (submit,
    duration, gpus) rows."""
    sub = np.full(max_jobs, np.inf, np.float32)
    dur = np.zeros(max_jobs, np.float32)
    gp = np.zeros(max_jobs, np.int32)
    for i, (s, d, g) in enumerate(jobs):
        sub[i], dur[i], gp[i] = s, d, g
    valid = np.isfinite(sub)
    tr = tcore.Trace(*(torch.from_numpy(x)[None] for x in
                       (sub, dur, gp, np.zeros(max_jobs, np.int32), valid)))
    return tr, tcore.SimParams(n_nodes, gpus, max_jobs, **kw)


def test_running_queue_order_and_mask():
    """``tests/test_sim_core.py``'s case: slot 0 is the most attained
    GPU-service, the preempt mask follows slot occupancy, and preempting
    returns the job to the queue with its service kept."""
    tr, sp = _one([(0.0, 50.0, 1), (0.0, 50.0, 2)], 1, 4, 4, queue_len=2,
                  preempt_len=2)
    st = tcore.init_state(sp, tr)
    for j in (0, 1):
        st, _ = tcore.try_place(sp, st, tr, torch.tensor([j]), None)
    st = tcore.advance_to(st, tr, torch.tensor([10.0]))
    np.testing.assert_array_equal(tcore.running_queue(sp, st, tr).numpy(),
                                  [[1, 0]])
    np.testing.assert_array_equal(tcore.action_mask(sp, st, tr).numpy(),
                                  [[0, 0, 1, 1, 1]])
    st, info = tcore.rl_step(sp, st, tr, torch.tensor([sp.queue_len]))
    assert bool(info.preempted) and not bool(info.placed)
    assert float(info.dt) == 0.0
    assert int(st.status[0, 1]) == tcore.PENDING
    assert float(st.remaining[0, 1]) == 40.0 and int(st.free.sum()) == 3


def test_preempt_keeps_attained_service():
    """``tests/test_sim_core.py``'s case: a preempted gang returns its
    GPUs and its job to the queue, and its 4 s x 2 GPUs of service stay
    attained."""
    tr, sp = _one([(0.0, 10.0, 2)], 1, 2, 2, queue_len=2)
    st = tcore.init_state(sp, tr)
    st, ok = tcore.try_place(sp, st, tr, torch.tensor([0]),
                             torch.tensor([tcore.PACK]))
    st = tcore.advance_to(st, tr, torch.tensor([4.0]))
    st, ok = tcore.preempt(st, torch.tensor([0]), sp.max_jobs)
    assert bool(ok) and int(st.status[0, 0]) == tcore.PENDING
    assert int(st.free.sum()) == 2 and float(st.remaining[0, 0]) == 6.0
    assert float(tcore.attained_service(st, tr)[0, 0]) == 8.0
    # preempting a job that is not running fails and changes nothing
    again, ok = tcore.preempt(st, torch.tensor([0]), sp.max_jobs)
    assert not bool(ok) and torch.equal(again.free, st.free)


def test_replace_after_preempt_is_not_first_and_is_charged():
    """A place->preempt->re-place cycle: the re-placement is not a first
    placement (no place bonus twice), and ``preempt_charge`` costs both
    legs, so every round trip reads strictly negative reward (the
    pause-the-game exploit of ``tests/test_env.py``)."""
    tr, sp = _one([(0.0, 50.0, 2)], 1, 2, 2, queue_len=2, preempt_len=1)
    ep = tenv.EnvParams(sim=sp, place_bonus=0.05, preempt_cost=0.25)
    st, _ = tenv.reset(ep, tr)
    rewards, firsts = [], []
    for a in (0, 2, 0, 2, 0):       # place, preempt, re-place, ...
        st, ts = tenv.step(ep, st, tr, torch.tensor([a]))
        rewards.append(float(ts.reward))
        firsts.append(bool(ts.info.first_placed))
    assert firsts == [True, False, False, False, False]
    assert rewards[0] == pytest.approx(0.05)
    assert all(r == -0.25 for r in rewards[1:])
    assert sum(rewards[1:3]) < 0


def test_non_preemptive_mask_and_step_are_unchanged():
    """With R = 0 the mask has no preempt block, and the charge of a
    preset's ``preempt_cost`` leaves every reward's bits as they are:
    it is exactly -0.0 there, so ``env.step`` skips it (JAX adds it)."""
    jsp, tsp = _sims(1, 0)
    wins = _integer_windows()
    ttr = tenv.stack_traces(wins, tsp, device="cpu")
    plain = tenv.EnvParams(sim=tsp, place_bonus=0.05, reward_scale=1e4)
    charged = dataclasses.replace(plain, preempt_cost=0.25)
    s1, ts1 = tenv.reset(plain, ttr)
    s2, _ = tenv.reset(charged, ttr)
    assert tsp.n_actions == K + 1 and ts1.action_mask.shape == (E, K + 1)
    rng = np.random.default_rng(3)
    for _ in range(40):
        a = torch.from_numpy(_actions(rng, ts1.action_mask.numpy()))
        s1, ts1 = tenv.step(plain, s1, ttr, a)
        s2, ts2 = tenv.step(charged, s2, ttr, a)
        assert ts1.reward.numpy().tobytes() == ts2.reward.numpy().tobytes()
        assert not (ts1.info.placed & ~ts1.info.first_placed).any()
        added = ts2.reward + trewards.preempt_charge(ts2.info, 0.25)
        assert added.numpy().tobytes() == ts1.reward.numpy().tobytes()


def _tanh_fields(obs_kind, R):
    """bool mask over one cluster's observation: True at the fields
    computed through tanh (compared in ulps), False at the exact ones."""
    if obs_kind == "flat":
        q = np.zeros((K, 4), bool)
        q[:, 1:3] = True
        r = np.zeros((R, 4), bool)
        r[:, 1:3] = True
        return np.concatenate([np.zeros(N, bool), q.ravel(), r.ravel(),
                               np.zeros(2, bool)])
    if obs_kind == "grid":
        m = np.zeros((N + K + R, G, 2), bool)
        m[..., 1] = True
        return m
    m = np.zeros((N + K + R, tobs.GRAPH_FEATURES), bool)
    m[:N, 2] = True
    m[N:, 1:3] = True
    return m


def _ulps(x, y):
    xi = x.view(np.int32).astype(np.int64)
    yi = y.view(np.int32).astype(np.int64)
    xi = np.where(xi < 0, np.int64(-2**31) - xi, xi)
    yi = np.where(yi < 0, np.int64(-2**31) - yi, yi)
    return np.where(x == y, 0, np.abs(xi - yi))


def _check_ts(step, jts, tts, fields):
    np.testing.assert_array_equal(np.asarray(jts.action_mask),
                                  tts.action_mask.numpy(), err_msg=f"{step}")
    np.testing.assert_array_equal(np.asarray(jts.done), tts.done.numpy())
    assert np.asarray(jts.reward).tobytes() == tts.reward.numpy().tobytes(), \
        step
    jo, to = np.asarray(jts.obs), tts.obs.numpy()
    assert jo.shape == to.shape and jo.dtype == to.dtype
    exact = np.broadcast_to(~fields, jo.shape)
    np.testing.assert_array_equal(jo[exact], to[exact],
                                  err_msg=f"step {step} exact fields")
    assert _ulps(jo[~exact], to[~exact]).max(initial=0) <= ULPS, step


ENV_CASES = [("flat", 1, 4), ("grid", 1, 4), ("graph", 2, 0),
             ("graph", 2, 4)]


@pytest.mark.parametrize("kind,P,R", ENV_CASES,
                         ids=[f"{k}-P{p}-R{r}" for k, p, r in ENV_CASES])
def test_env_step_matches_jax(kind, P, R):
    jsp, tsp = _sims(P, R)
    kw = dict(obs_kind=kind, horizon=STEPS + 8, place_bonus=0.05,
              reward_scale=1e4, time_scale=600.0, preempt_cost=0.25)
    jp, tp = jenv.EnvParams(sim=jsp, **kw), tenv.EnvParams(sim=tsp, **kw)
    assert jp.obs_shape() == tp.obs_shape()
    wins = _integer_windows(rate=0.08, mean_duration=600.0)
    jtr = jenv.stack_traces(wins, jp)
    ttr = tenv.stack_traces(wins, tp, device="cpu")
    jst, jts = jax.jit(lambda tr: jenv.vec_reset(jp, tr))(jtr)
    tst, tts = tenv.vec_reset(tp, ttr)
    fields = _tanh_fields(kind, R)
    _check_ts(-1, jts, tts, fields)
    jstep = jax.jit(jax.vmap(lambda s, tr, a: jenv.step(jp, s, tr, a)))
    rng = np.random.default_rng(5)
    charged = 0
    for i in range(STEPS):
        a = _actions(rng, tts.action_mask.numpy())
        jst, jts = jstep(jst, jtr, jnp.asarray(a))
        tst, tts = tenv.step(tp, tst, ttr, torch.from_numpy(a))
        _assert_state_equal(i, jst.sim, tst.sim)
        _check_ts(i, jts, tts, fields)
        charged += int((tts.info.preempted.numpy()).sum())
    if R:
        assert charged > 0


def test_build_adjacency_matches_jax():
    for args in [(4, 2, 2, 0), (16, 8, 4, 0), (5, 3, None, 4),
                 (16, 8, 4, 4)]:
        a = tobs.build_adjacency(*args)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, jobs.build_adjacency(*args))
    a = tobs.build_adjacency(4, 2, nodes_per_rack=2)
    assert a[0, 1] == 1 and a[0, 2] == 0 and a[0, 4] == 1 and a[4, 5] == 0


def test_gate_stalled_matches_jax():
    sp_kw = dict(obs_kind="flat")
    for P, R in [(1, 4), (2, 3), (2, 0)]:
        jsp, tsp = _sims(P, R)
        jp = jenv.EnvParams(sim=jsp, **sp_kw)
        tp = tenv.EnvParams(sim=tsp, **sp_kw)
        assert tdecision.stall_threshold(tp) == \
            jdecision.stall_threshold(jp) == K + R + 4
        jpre, tpre = jdecision.preempt_slice(jp), tdecision.preempt_slice(tp)
        if not R:
            assert jpre is None and tpre is None
            continue
        np.testing.assert_array_equal(np.asarray(jpre), tpre.numpy())
        rng = np.random.default_rng(R)
        mask = rng.random((64, tsp.n_actions)) < 0.7
        stall = rng.integers(0, 2 * (K + R + 4), size=64).astype(np.int32)
        thresh = K + R + 4
        want = jax.jit(lambda m, s: jdecision.gate_stalled(
            m, s, thresh, jpre))(mask, stall)
        got = tdecision.gate_stalled(torch.from_numpy(mask),
                                     torch.from_numpy(stall), thresh, tpre)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        assert (got.numpy() != mask).any()


def test_stall_gate_masks_preempts_when_served():
    """``tests/test_serve.py``'s case: a stalled request is never served
    a preempt; an un-stalled one gets ``policy_decision`` on its own
    mask; a batch mixing both gets the decision on the gated mask. The
    policy is made to prefer preempting, so the gate has work to do."""
    from rlgpuschedule_tpu_torch.decision import policy_decision
    from rlgpuschedule_tpu_torch.models import make_policy
    from rlgpuschedule_tpu_torch.serve import InferenceEngine
    _, tsp = _sims(1, 4)
    tp = tenv.EnvParams(sim=tsp)
    ttr = tenv.stack_traces(_integer_windows(), tp, device="cpu")
    _, ts = tenv.reset(tp, ttr)
    obs = ts.obs.numpy()
    mask = np.ones_like(ts.action_mask.numpy())     # every action legal
    policy = make_policy("flat", tp.n_actions, tp.obs_shape(),
                         dtype=torch.float32, device="cpu")
    pre = tdecision.preempt_slice(tp).numpy()
    with torch.no_grad():
        policy.policy.bias[torch.from_numpy(pre)] = 10.0
    engine = InferenceEngine(policy, max_bucket=8, device="cpu",
                             env_params=tp)
    thresh = tdecision.stall_threshold(tp)
    stalled = np.full(E, thresh, np.int32)
    actions, bucket = engine.decide(obs, mask, stalled)
    assert bucket == E and not pre[actions].any()
    calm, _ = engine.decide(obs, mask, np.zeros_like(stalled))
    assert pre[calm].all()
    mixed = np.array([0, thresh, thresh - 1, thresh + 5], np.int32)
    got, _ = engine.decide(obs[:3], mask[:3], mixed[:3])
    gated = tdecision.gate_stalled(torch.from_numpy(mask),
                                   torch.from_numpy(mixed), thresh,
                                   torch.from_numpy(pre))
    want = policy_decision(policy, torch.from_numpy(obs), gated).numpy()
    np.testing.assert_array_equal(got, want[:3])
    # without env_params nothing is gated
    eng = InferenceEngine(policy, max_bucket=8, device="cpu")
    open_, _ = eng.decide(obs, mask, stalled)
    np.testing.assert_array_equal(open_, calm)
