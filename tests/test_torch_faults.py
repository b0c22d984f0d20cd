"""Parity of the port's cluster fault process with the JAX package.

- Each regime's seeded ``FaultSchedule`` is JAX's bit for bit, at three
  seeds; the event-list ingest, the validation and the stats agree.
- One batched episode runs every regime at once (env ``e`` under regime
  ``e``'s schedule) through both packages' env step, with the health
  channel on, the pack|spread placements and a preempt block: the sim
  state, the step info, the mask, the reward and the health channel are
  bit-identical to jitted JAX's at every step (the other observation
  features within rtol 1e-6 / atol 1e-7, the tanh of
  ``tests/test_torch_sim.py``). Under ``no_faults`` the port's step is
  its ``faults=None`` step, state for state.
- ``OracleSim(faults=)`` follows JAX's under the same actions, field for
  field, and the baselines give JAX's JCTs; the batched simulator
  follows its own oracle (integer schedules, dyadic slowdowns: exact in
  f32, JAX's own oracle-parity regime, clocks within 1e-3).
- GPUs and jobs are conserved at every step of a random walk.
- A rollout under faults replays JAX's actions to JAX's transitions, and
  one PPO learn step on them lands within ``tests/test_torch_algos.py``'s
  tolerance (rtol 1e-5 / atol 1e-5).
- The JAX Tiresias livelocks under a straggler draw; the port's ends.
- The train, evaluate and serve flags of the slice run on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training.train_state import TrainState

from rlgpuschedule_tpu.algos import ppo as jppo
from rlgpuschedule_tpu.algos.rollout import init_carry as jinit_carry
from rlgpuschedule_tpu.algos.rollout import rollout as jrollout
from rlgpuschedule_tpu.env import env as jenv
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu.sim import core as jcore
from rlgpuschedule_tpu.sim import faults as jfaults
from rlgpuschedule_tpu.sim import oracle as joracle
from rlgpuschedule_tpu.sim import schedulers as jsched
from rlgpuschedule_tpu.traces import gen_poisson_trace as jpoisson
from rlgpuschedule_tpu_torch.algos import action_dist as tdist
from rlgpuschedule_tpu_torch.algos import ppo as tppo
from rlgpuschedule_tpu_torch.algos.rollout import (Transition, init_carry,
                                                   rollout)
from rlgpuschedule_tpu_torch.env import env as tenv
from rlgpuschedule_tpu_torch.models import make_policy, params_from_jax
from rlgpuschedule_tpu_torch.sim import core as tcore
from rlgpuschedule_tpu_torch.sim import faults as tfaults
from rlgpuschedule_tpu_torch.sim import oracle as toracle
from rlgpuschedule_tpu_torch.sim import schedulers as tsched

torch.set_num_threads(1)

N, G, J, K, P, R = 6, 4, 20, 4, 2, 2
REGIMES = ("none", "sporadic", "storm", "straggler")
E = len(REGIMES)
STEPS = 200


def _integer_windows(n=E, rate=0.02):
    out = []
    for s in range(n):
        tr = jpoisson(rate, J, seed=10 + s, max_jobs=J, mean_duration=400.0)
        out.append(dataclasses.replace(
            tr,
            submit=np.where(tr.valid, np.round(tr.submit),
                            np.inf).astype(np.float32),
            duration=np.maximum(np.round(tr.duration), 1.0
                                ).astype(np.float32),
            gpus=np.minimum(tr.gpus, N * G).astype(np.int32)))
    return out


WINDOWS = _integer_windows()
HORIZON = tfaults.fault_horizon(WINDOWS)


def _schedules(pkg):
    """Env e's schedule: regime e drawn from (7, e), padded to the storm's
    two windows per node with +inf (a window never entered), so the
    four stack into one batch."""
    out = []
    for e, r in enumerate(REGIMES):
        fs = pkg.sample_fault_schedule(N, r, (7, e), HORIZON)
        pad = np.full((N, 2 - fs.down_start.shape[1]), np.inf, np.float32)
        out.append(fs._replace(
            down_start=np.concatenate([fs.down_start, pad], 1),
            down_end=np.concatenate([fs.down_end, pad], 1)))
    return out


def _params(**over):
    kw = dict(obs_kind="flat", horizon=STEPS + 8, place_bonus=0.05,
              reward_scale=1e4, time_scale=600.0, preempt_cost=0.25,
              fault_obs=True)
    kw.update(over)
    return (jenv.EnvParams(sim=jcore.SimParams(N, G, J, K, P, R), **kw),
            tenv.EnvParams(sim=tcore.SimParams(N, G, J, K, P, R), **kw))


# ---- the samplers -----------------------------------------------------------

@pytest.mark.parametrize("regime", sorted(jfaults.FAULT_REGIMES))
def test_sampled_schedules_are_jax_bit_for_bit(regime):
    for seed in (0, 5, (3, 1)):
        want = jfaults.sample_fault_schedule(8, regime, seed, 1234.5)
        got = tfaults.sample_fault_schedule(8, regime, seed, 1234.5)
        for f in want._fields:
            x, y = np.asarray(getattr(want, f)), getattr(got, f)
            assert x.dtype == y.dtype and x.shape == y.shape, (f, seed)
            np.testing.assert_array_equal(x, y, err_msg=f"{f} {seed}")
        assert tfaults.schedule_stats(got) == jfaults.schedule_stats(want)
    batched = tfaults.sample_env_fault_schedules(8, regime, 4, 3, 99.0,
                                                 device="cpu")
    jb = jfaults.sample_env_fault_schedules(8, regime, 4, 3, 99.0)
    for f in jb._fields:
        np.testing.assert_array_equal(getattr(batched, f).numpy(),
                                      np.asarray(getattr(jb, f)))
    assert tfaults.schedule_stats(batched) == jfaults.schedule_stats(jb)


def test_validation_and_event_ingest_match_jax():
    args = (4, [0, 2, 0], [10.0, 5.0, 1.0], [3.0, 4.0, 2.0])
    want = jfaults.fault_schedule_from_events(*args, slowdown=[1, 2, 1, 3])
    got = tfaults.fault_schedule_from_events(*args, slowdown=[1, 2, 1, 3])
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)))
    assert tfaults.fault_horizon(WINDOWS) == jfaults.fault_horizon(WINDOWS)
    bad = [
        jfaults.FaultSchedule(np.array([[5.0]], np.float32),
                              np.array([[4.0]], np.float32),
                              np.ones(1, np.float32)),
        jfaults.FaultSchedule(np.array([[np.inf, 3.0]], np.float32),
                              np.array([[np.inf, 4.0]], np.float32),
                              np.ones(1, np.float32)),
        jfaults.FaultSchedule(np.array([[1.0]], np.float32),
                              np.array([[2.0]], np.float32),
                              np.full(1, 0.5, np.float32)),
    ]
    for fs in bad:
        with pytest.raises(ValueError) as je:
            jfaults.validate_fault_schedule(1, fs)
        with pytest.raises(ValueError) as te:
            tfaults.validate_fault_schedule(1, fs)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="unknown fault regime"):
        tfaults.sample_fault_schedule(2, "meteor", 0, 100.0)
    with pytest.raises(ValueError, match="cluster has 3"):
        tcore.validate_trace(tcore.SimParams(3, 2, J), WINDOWS[0],
                             clamp=True, faults=tfaults.no_faults(2))


# ---- the env step under a schedule per regime -------------------------------

def _check(step, jst, jts, tst, tts):
    for name in jst.sim._fields:
        x = np.asarray(getattr(jst.sim, name))
        y = getattr(tst.sim, name).numpy()
        assert x.dtype == y.dtype, (step, name)
        np.testing.assert_array_equal(x, y, err_msg=f"step {step} {name}")
    for name in jts.info._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jts.info, name)),
                                      getattr(tts.info, name).numpy(),
                                      err_msg=f"step {step} {name}")
    for name in ("action_mask", "done", "reward"):
        np.testing.assert_array_equal(np.asarray(getattr(jts, name)),
                                      getattr(tts, name).numpy(),
                                      err_msg=f"step {step} {name}")
    jo, to = np.asarray(jts.obs), tts.obs.numpy()
    # the health channel is bit-identical; the rest carries the tanh ulp
    np.testing.assert_array_equal(to[:, -N:], jo[:, -N:],
                                  err_msg=f"step {step} health")
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-7,
                               err_msg=f"step {step} obs")


def test_episode_under_every_regime_is_jax_bit_for_bit():
    jp, tp = _params()
    jtr = jenv.stack_traces(WINDOWS, jp)
    ttr = tenv.stack_traces(WINDOWS, tp, device="cpu")
    jf = jfaults.stack_fault_schedules(_schedules(jfaults))
    tf = tfaults.stack_fault_schedules(_schedules(tfaults), "cpu")
    jst, jts = jax.jit(lambda tr, f: jenv.vec_reset(jp, tr, f))(jtr, jf)
    tst, tts = tenv.vec_reset(tp, ttr, tf)
    _check(-1, jst, jts, tst, tts)
    jstep = jax.jit(jax.vmap(lambda s, tr, a, f: jenv.step(jp, s, tr, a, f)))
    # the same episode with no_faults, against faults=None
    nf = tfaults.stack_fault_schedules([tfaults.no_faults(N, 2)] * E, "cpu")
    ast, ats = tenv.vec_reset(tp, ttr, nf)
    bst, bts = tenv.vec_reset(tp, ttr)
    rng = np.random.default_rng(3)
    killed = drained = stretched = 0
    for i in range(STEPS):
        m = np.asarray(jts.action_mask)
        a = np.array([rng.choice(np.flatnonzero(r)) for r in m], np.int32)
        before = np.asarray(jst.sim.status)
        jst, jts = jstep(jst, jtr, jnp.asarray(a), jf)
        tst, tts = tenv.step(tp, tst, ttr, torch.from_numpy(a), tf)
        _check(i, jst, jts, tst, tts)
        after = np.asarray(jst.sim.status)
        pre = np.asarray(jts.info.preempted)
        killed += int(((before == 2) & (after == 1))[~pre].sum())
        health = tts.obs[:, -N:]
        drained += int((health == 0).sum())
        stretched += int(((health > 0) & (health < 1)).sum())
        # no_faults is the identity of every consumer
        mb = np.array([rng.choice(np.flatnonzero(r))
                       for r in bts.action_mask.numpy()], np.int32)
        ast, ats = tenv.step(tp, ast, ttr, torch.from_numpy(mb), nf)
        bst, bts = tenv.step(tp, bst, ttr, torch.from_numpy(mb))
        for x, y in zip(ast.sim, bst.sim):
            assert torch.equal(x, y), i
        for x, y in zip((ats.obs, ats.reward, ats.action_mask),
                        (bts.obs, bts.reward, bts.action_mask)):
            assert torch.equal(x, y), i
        if bool(np.asarray(jts.done).all()):
            break
    assert bool(np.asarray(jts.info.done).any()), "no episode finished"
    assert killed > 0 and drained > 0 and stretched > 0, \
        (killed, drained, stretched)


def test_conservation_holds_at_every_step_of_a_random_walk():
    _, tp = _params(horizon=10_000)
    ttr = tenv.stack_traces(WINDOWS, tp, device="cpu")
    tf = tfaults.stack_fault_schedules(_schedules(tfaults), "cpu")
    st, ts = tenv.vec_reset(tp, ttr, tf)
    gpus, valid = ttr.gpus.numpy(), ttr.valid.numpy()
    rng = np.random.default_rng(11)
    for i in range(300):
        a = rng.integers(0, tp.n_actions, size=E)
        st, ts = tenv.step(tp, st, ttr, torch.tensor(a, dtype=torch.int32),
                           tf)
        s = st.sim
        alloc, free = s.alloc.numpy(), s.free.numpy()
        np.testing.assert_array_equal(alloc.sum(1) + free, G, str(i))
        status = s.status.numpy()
        running = status == 2
        np.testing.assert_array_equal(alloc.sum(2)[running], gpus[running])
        assert (alloc.sum(2)[~running] == 0).all(), i
        assert np.isin(status[valid], (0, 1, 2, 3)).all(), i
        up = tfaults.node_up(tf, s.clock).numpy()
        assert (alloc.transpose(0, 2, 1)[~up] == 0).all(), i
        if bool(ts.info.done.all()):
            break


# ---- the oracle ------------------------------------------------------------

def test_oracle_follows_jax_under_every_regime():
    rng = np.random.default_rng(5)
    for w, jf, tf in zip(WINDOWS, _schedules(jfaults), _schedules(tfaults)):
        js = joracle.OracleSim(w, N, G, faults=jf)
        ts = toracle.OracleSim(w, N, G, faults=tf)
        for i, a in enumerate(rng.integers(0, K * P + R + 1, size=400)):
            ji = js.rl_step(int(a), K, P, R)
            ti = ts.rl_step(int(a), K, P, R)
            assert ti == ji, i
            assert ts.clock == js.clock
            for f in ("status", "remaining", "alloc", "free", "start",
                      "finish"):
                np.testing.assert_array_equal(getattr(ts, f),
                                              getattr(js, f), f"{i} {f}")
            assert ts.gpus_consistent()
            if ji["done"]:
                break
        assert js.done()
        np.testing.assert_array_equal(ts.jcts(), js.jcts())


@pytest.mark.parametrize("name", ["fifo", "sjf", "srtf", "tiresias"])
def test_baselines_under_faults_give_jax_jcts(name):
    for e, (w, jf, tf) in enumerate(zip(WINDOWS, _schedules(jfaults),
                                        _schedules(tfaults))):
        if name == "tiresias" and REGIMES[e] == "straggler":
            continue    # JAX's Tiresias wake ignores the stretch (below)
        want = jsched.run_baseline(w, N, G, name, faults=jf).jcts()
        got = tsched.run_baseline(w, N, G, name, faults=tf).jcts()
        np.testing.assert_array_equal(got, want, f"{name} {REGIMES[e]}")
    with pytest.raises(ValueError, match="no fault model"):
        tsched.run_baseline(WINDOWS[0], N, G, name, backend="native",
                            faults=tfaults.no_faults(N))


def _int_faults(rng, n_waves=2):
    """Integer drain windows and dyadic slowdowns: exact in f32."""
    fs = tfaults.no_faults(N, n_waves)
    for n in range(N):
        if rng.random() < 0.6:
            t = 0
            for w in range(int(rng.integers(1, n_waves + 1))):
                t += int(rng.integers(1, 300))
                d = int(rng.integers(1, 200))
                fs.down_start[n, w], fs.down_end[n, w] = t, t + d
                t += d
        if rng.random() < 0.5:
            fs.slowdown[n] = float(rng.choice([2.0, 4.0]))
    return tfaults.validate_fault_schedule(N, fs)


def test_the_batched_sim_follows_its_own_oracle():
    params = tcore.SimParams(N, G, J, K, P, R)
    rng = np.random.default_rng(9)
    schedules = [_int_faults(rng) for _ in range(E)]
    tr = tcore.Trace.from_array_traces(WINDOWS, params, "cpu")
    tf = tfaults.stack_fault_schedules(schedules, "cpu")
    sims = [toracle.OracleSim(w, N, G, faults=f)
            for w, f in zip(WINDOWS, schedules)]
    state = tcore.init_state(params, tr, tf)
    for i, a in enumerate(rng.integers(0, params.n_actions, size=(500, E))):
        state, info = tcore.rl_step(params, state, tr,
                                    torch.tensor(a, dtype=torch.int32), tf)
        for e, sim in enumerate(sims):
            if sim.done():
                continue
            oi = sim.rl_step(int(a[e]), K, P, R)
            ctx = f"step {i} env {e}"
            np.testing.assert_allclose(float(state.clock[e]), sim.clock,
                                       atol=1e-3, err_msg=ctx)
            np.testing.assert_array_equal(state.status[e].numpy(),
                                          sim.status, ctx)
            np.testing.assert_array_equal(state.alloc[e].numpy(),
                                          sim.alloc, ctx)
            np.testing.assert_array_equal(state.free[e].numpy(), sim.free,
                                          ctx)
            np.testing.assert_allclose(state.remaining[e].numpy(),
                                       sim.remaining, atol=1e-3,
                                       err_msg=ctx)
            assert bool(info.placed[e]) == oi["placed"], ctx
            assert bool(info.done[e]) == oi["done"], ctx
        if all(s.done() for s in sims):
            break
    assert all(s.done() for s in sims)


def _tiresias_steps(sched, oracle, w, fs, cap=3000):
    """Event-loop rounds of Tiresias (``run_scheduler``'s loop) until the
    trace is done, or None after ``cap`` rounds."""
    sim = oracle.OracleSim(w, 4, 4, faults=fs)
    pol = sched.BASELINES["tiresias"]()
    sim.reset()
    for n in range(cap):
        sched.schedule_step(sim, pol)
        if sim.done():
            return n
        t = min(sim.next_event_time(), pol.next_wake(sim))
        if sim.advance_to(t) <= 0.0 and not sim.done():
            sim.advance_to_next_event()
    return None


def test_tiresias_ends_under_the_straggler_draw_where_jax_livelocks():
    """JAX's Tiresias wakes as if a straggling gang attained service at
    the full rate: the wake comes early, and once the gap to the
    threshold is under the remaining work's f64 spacing, each wake
    advances the clock one ulp and changes nothing. On this draw (config
    1 cut to 4 x 4 GPUs, window 1, the straggler regime at (0, 1)) it
    spins; the port's wake accounts for the stretch and passes over a
    crossing that rounding has reached."""
    from rlgpuschedule_tpu_torch import experiment as texp
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    cfg = dataclasses.replace(CONFIGS["ppo-mlp-synth64"], n_nodes=4,
                              gpus_per_node=4, window_jobs=12, n_envs=2)
    source = tcore.validate_trace(texp.build_env_params(cfg).sim,
                                  texp.load_source_trace(cfg), clamp=True)
    wins = texp.make_env_windows(cfg, source)
    fs = tfaults.sample_fault_schedule(4, "straggler", (0, 1),
                                       tfaults.fault_horizon(wins))
    assert _tiresias_steps(jsched, joracle, wins[1], fs) is None
    n = _tiresias_steps(tsched, toracle, wins[1], fs)
    assert n is not None and n < 100, n
    res = tsched.run_baseline(wins[1], 4, 4, "tiresias", faults=fs)
    assert res.jcts().size == wins[1].num_jobs
    # without the straggler the two packages' Tiresias agree
    clean = fs._replace(slowdown=np.ones(4, np.float32))
    np.testing.assert_array_equal(
        tsched.run_baseline(wins[1], 4, 4, "tiresias", faults=clean).jcts(),
        jsched.run_baseline(wins[1], 4, 4, "tiresias", faults=clean).jcts())


# ---- the rollout and one learn step under faults ---------------------------

T, CFG = 8, dict(n_steps=8, n_epochs=2, n_minibatches=2)


def test_rollout_and_learn_step_under_faults_match_jax():
    jp, tp = _params(horizon=5)      # episodes end inside the rollout
    jtr = jenv.stack_traces(WINDOWS, jp)
    ttr = tenv.stack_traces(WINDOWS, tp, device="cpu")
    jf = jfaults.stack_fault_schedules(_schedules(jfaults))
    tf = tfaults.stack_fault_schedules(_schedules(tfaults), "cpu")
    jnet = jmake_policy("flat", jp.n_actions, dtype=jnp.float32)
    cfg = jppo.PPOConfig(**CFG)
    carry = jax.jit(lambda tr, f: jinit_carry(jp, tr, jax.random.PRNGKey(4),
                                              f))(jtr, jf)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(3), carry.obs[:1],
                                carry.mask[:1])
    jstate = TrainState.create(apply_fn=jnet.apply, params=params,
                               tx=jppo.make_optimizer(cfg))
    _, jtrans, jlast = jax.jit(lambda p, c, tr, f: jrollout(
        jnet.apply, p, jp, tr, c, T, f))(params, carry, jtr, jf)
    key = jax.random.PRNGKey(2)
    jstate2, jm = jax.jit(jppo.make_learn_step(jnet.apply, cfg))(
        jstate, jtrans, jlast, key)

    net = make_policy("flat", tp.n_actions, tp.obs_shape(),
                      dtype=torch.float32, device="cpu")
    net.load_state_dict(params_from_jax(jax.device_get(params)))
    actions = iter(torch.tensor(np.asarray(jtrans.action)))

    def replay(gen, logits):
        a = next(actions)
        return a, tdist.log_prob(logits, a)

    tcarry = init_carry(tp, ttr, torch.Generator().manual_seed(0), tf)
    _, trans, last = rollout(net, tp, ttr, tcarry, T, sample_fn=replay,
                             faults=tf)
    assert bool(np.asarray(jtrans.done).any()), "no episode ended"
    for f in ("action", "reward", "done", "mask", "env_steps_dt"):
        np.testing.assert_array_equal(getattr(trans, f).numpy(),
                                      np.asarray(getattr(jtrans, f)), f)
    np.testing.assert_allclose(trans.obs.numpy(), np.asarray(jtrans.obs),
                               rtol=1e-6, atol=1e-7)
    # the learn step on JAX's own batch, with JAX's permutations
    state = tppo.make_train_state(net, tppo.PPOConfig(**CFG))
    perms = []
    k = key
    for _ in range(CFG["n_epochs"]):
        k, sub = jax.random.split(k)
        perms.append(torch.tensor(np.asarray(
            jax.random.permutation(sub, T * E))))
    jt = Transition(*(torch.tensor(np.asarray(x)) for x in jtrans))
    state, m = tppo.make_learn_step(tppo.PPOConfig(**CFG))(
        state, jt, torch.tensor(np.asarray(jlast)), perms=perms)
    want = params_from_jax(jax.device_get(jstate2.params))
    for name, p in state.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    for f in jppo.PPOMetrics._fields:
        np.testing.assert_allclose(float(getattr(m, f)),
                                   float(getattr(jm, f)), rtol=1e-4,
                                   atol=1e-6, err_msg=f)


def test_hier_and_grid_refuse_the_health_channel_as_jax_does():
    from rlgpuschedule_tpu_torch.env import hier as thier
    with pytest.raises(ValueError, match="FLAT"):
        tenv.EnvParams(sim=tcore.SimParams(N, G, J, K), obs_kind="grid",
                       fault_obs=True)
    with pytest.raises(ValueError, match="no fault-process"):
        thier.vec_reset(None, None, faults=tfaults.no_faults(N))


# ---- the CLIs ---------------------------------------------------------------

TINY = ["--config", "ppo-mlp-synth64", "--n-nodes", "4", "--gpus-per-node",
        "4", "--window-jobs", "12", "--queue-len", "4", "--horizon", "96",
        "--n-envs", "2"]
TRAIN = ["--n-steps", "8", "--n-epochs", "1", "--n-minibatches", "2",
         "--iterations", "2", "--log-every", "1"]
CPU = ["--device", "cpu"]


def _last_json(capsys):
    import json
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Two train CLI iterations each, clean, under storm faults and
    across mixed domains, checkpointed."""
    from rlgpuschedule_tpu_torch import train as ttrain
    root = tmp_path_factory.mktemp("chaos")
    out = {}
    for label, flags in (("clean", []), ("storm", ["--faults", "storm"]),
                         ("mixed", ["--domains", "mixed"])):
        out[label] = str(root / label)
        out[label, "summary"] = ttrain.main(
            TINY + TRAIN + CPU + flags + ["--ckpt-dir", out[label]])
    return out


def test_train_cli_takes_faults_and_domains(ckpts):
    import json
    import os
    for label in ("storm", "mixed"):
        s = ckpts[label, "summary"]
        assert s["iterations"] == 2 and s["env_steps_per_sec"] > 0
        step = max(int(d) for d in os.listdir(ckpts[label])
                   if d.isdigit())
        meta = json.load(open(os.path.join(ckpts[label], str(step),
                                           "meta.json")))
        cfg = meta["config"]
        assert (cfg["faults"], cfg["domains"]) == (
            ("storm", None) if label == "storm" else (None, "mixed"))


def test_evaluate_cli_chaos_runs_on_the_cpu(ckpts, capsys):
    from rlgpuschedule_tpu_torch import evaluate as tevaluate
    tevaluate.main(TINY + CPU + ["--faults", "storm", "--ckpt-dir",
                                 ckpts["storm"], "--chaos",
                                 "--chaos-regimes", "storm,straggler"])
    line = _last_json(capsys)
    assert line["chaos_regimes"] == ["none", "storm", "straggler"]
    assert line["jobs_lost"] == 0 and line["device"] == "cpu"
    assert set(line["regimes"]["storm"]) == {"policy", "sjf", "tiresias"}
    assert line["repro"]["faults"] == "storm"
    assert line["repro"]["ckpt_step"] is not None


def test_evaluate_cli_matrix_runs_on_the_cpu(ckpts, capsys):
    from rlgpuschedule_tpu_torch import evaluate as tevaluate
    tevaluate.main(TINY + CPU + [
        "--domains", "mixed", "--ckpt-dir", ckpts["mixed"], "--matrix",
        "--matrix-regimes", "overload", "--matrix-baselines", "fifo",
        "--matrix-ckpt", f"clean={ckpts['clean']}"])
    line = _last_json(capsys)
    assert line["matrix_regimes"] == ["none", "overload"]
    assert set(line["cells"]["overload"]) == {"mixed", "clean", "fifo"}
    assert line["jobs_lost"] == 0
    assert line["repro"]["matrix_ckpts"] == [f"clean={ckpts['clean']}"]


def test_evaluate_cli_stitches_under_a_global_schedule(ckpts, capsys):
    from rlgpuschedule_tpu_torch import evaluate as tevaluate
    tevaluate.main(TINY + CPU + [
        "--faults", "storm", "--ckpt-dir", ckpts["storm"], "--full-trace",
        "--max-jobs", "40", "--stitch-drain-jobs", "4", "--no-random",
        "--stitch-faults", "storm", "--stitch-domain", "geom",
        "--stitch-seed", "2"])
    line = _last_json(capsys)
    assert line["faulty_cluster"] and line["n_jobs"] == 40
    assert line["baseline_backend"] == "python"
    r = line["repro"]
    assert (r["stitch_faults"], r["stitch_domain"], r["stitch_seed"]) == \
        ("storm", "geom", 2)
    assert r["stitch_domain_draw"]["spec"] == "geom"


def test_serve_cli_replays_the_fleet_under_a_regime(ckpts, capsys):
    from rlgpuschedule_tpu_torch.serve import __main__ as tserve
    tserve.main(TINY + CPU + ["--fleet", "3", "--fleet-regime", "storm",
                              "--fleet-seed", "4", "--max-steps", "48"])
    fleet = _last_json(capsys)["fleet"]
    assert (fleet["regime"], fleet["fleet_seed"]) == ("storm", 4)
    assert fleet["n_clusters"] == 3 and fleet["decisions"] > 0


@pytest.mark.parametrize("argv", [
    ["--chaos-regimes", "storm"],
    ["--matrix-seed", "3"],
    ["--stitch-faults", "storm"],
    ["--full-trace", "--stitch-seed", "2"],
    ["--chaos", "--chaos-regimes", "meteor"],
    ["--matrix", "--matrix-ckpt", "nowhere"],
    ["--chaos", "--full-trace"],
    ["--full-trace", "--stitch-domain", "moon"],
    ["--pbt", "--domains", "mixed"],
])
def test_evaluate_cli_refuses_chaos_misuse_like_jax(argv):
    from rlgpuschedule_tpu import evaluate as jevaluate
    from rlgpuschedule_tpu_torch import evaluate as tevaluate
    with pytest.raises(SystemExit) as je:
        jevaluate.main(TINY[:-2] + argv)
    with pytest.raises(SystemExit) as te:
        tevaluate.main(TINY[:-2] + argv + CPU)
    assert str(te.value) == str(je.value)


def test_the_slice_s_entry_points_default_to_cuda():
    """Without ``--device cpu`` the new flags ask for the card, and on a
    machine without one they raise."""
    from rlgpuschedule_tpu_torch import evaluate as tevaluate
    from rlgpuschedule_tpu_torch import train as ttrain
    from rlgpuschedule_tpu_torch.serve import __main__ as tserve
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(TINY + ["--faults", "storm", "--iterations", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tevaluate.main(TINY + ["--faults", "storm", "--chaos"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(TINY + ["--fleet", "2", "--fleet-regime", "storm"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tfaults.stack_fault_schedules([tfaults.no_faults(2)])
