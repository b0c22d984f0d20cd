"""The port's canary, watchdog and promotion ledger
(``flywheel/canary.py``) against the JAX package's.

- ``run_canary`` over the same logged window with converted incumbent
  and candidate weights gives JAX's report field for field: a clean
  candidate, a regressed one (the incumbent's agreement exactly 1.0), a
  single regressing slice that promotes, consecutive slices that block,
  a log nobody agrees with on one slice; the knobs are validated alike.
- ``SLOWatchdog`` on scripted gauges ticks as JAX's does: a p99 breach
  streak, a reset on a clean tick, a recompile as an immediate rollback,
  new shedding, the validation.
- ``PromotionLedger``/``read_ledger``: the round trip, the sealed prefix
  against the unsealed tail, a corrupt prefix, a missing ledger; each
  package reads the other's ledger.
- The swap path: a capture engine (and a capture router) take new
  weights with a re-warm that builds nothing, refuse a shape change,
  and give the incumbent's decisions back bit for bit.
"""
import dataclasses
import inspect
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu.experiment import build_env_params as jbuild
from rlgpuschedule_tpu.flywheel import canary as jcanary
from rlgpuschedule_tpu.flywheel.flightlog import FlightShard as JShard
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu.obs import Registry as JRegistry
from rlgpuschedule_tpu_torch import configs as tconfigs
from rlgpuschedule_tpu_torch.experiment import build_env_params as tbuild
from rlgpuschedule_tpu_torch.flywheel import canary as tcanary
from rlgpuschedule_tpu_torch.flywheel.flightlog import FlightShard
from rlgpuschedule_tpu_torch.models import make_policy, params_from_jax
from rlgpuschedule_tpu_torch.obs import EventBus, Registry, read_events
from rlgpuschedule_tpu_torch.serve import InferenceEngine
from rlgpuschedule_tpu_torch.serve.router import EngineRouter

torch.set_num_threads(1)

SMALL = dict(n_envs=2, window_jobs=12, horizon=96, n_nodes=4,
             gpus_per_node=4, queue_len=4, preempt_len=2)
N, SLICES = 80, 8


@pytest.fixture(scope="module")
def world():
    """Config 1 cut small (preempt slots on): JAX's f32 policy and its
    negation, the port's twins, 64 seeded rows, and an observation whose
    full-mask greedy action the negated weights flip."""
    jcfg = dataclasses.replace(jconfigs.CONFIGS["ppo-mlp-synth64"], **SMALL)
    tcfg = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"], **SMALL)
    jp, tp = jbuild(jcfg), tbuild(tcfg)
    net = jmake_policy("flat", jp.n_actions, dtype=jnp.float32)
    params = jax.device_get(jax.jit(net.init)(
        jax.random.PRNGKey(0), jnp.zeros((1,) + jp.obs_shape()),
        jnp.ones((1, jp.n_actions), bool)))
    neg = jax.tree.map(lambda x: -x, params)
    policy = make_policy("flat", tp.n_actions, tp.obs_shape(),
                         dtype=torch.float32, device="cpu")
    policy.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(7)
    obs = rng.standard_normal((64,) + tp.obs_shape()).astype(np.float32)
    full = np.ones(tp.n_actions, bool)
    with torch.no_grad():
        a0 = policy(torch.from_numpy(obs), torch.ones(64, tp.n_actions,
                                                       dtype=torch.bool))
        policy_neg = make_policy("flat", tp.n_actions, tp.obs_shape(),
                                 dtype=torch.float32, device="cpu")
        policy_neg.load_state_dict(params_from_jax(neg))
        a1 = policy_neg(torch.from_numpy(obs),
                        torch.ones(64, tp.n_actions, dtype=torch.bool))
    flips = np.flatnonzero((a0[0].argmax(-1) != a1[0].argmax(-1)).numpy())
    assert flips.size
    return dict(jp=jp, tp=tp, apply_fn=lambda p, o, m: net.apply(p, o, m),
                params=params, neg=neg, policy=policy,
                inc=params_from_jax(params), cand=params_from_jax(neg),
                row=obs[flips[0]], full=full, obs=obs)


def _window(world, flip_slices, corrupt=0):
    """JAX's window construction: forced rows (one legal action) agree
    for any policy, a flip slice's rows (a full mask at the flipping
    observation) part the negated candidate from the incumbent; the
    logged actions are the incumbent's replay (the port's and JAX's
    agree, checked). Returns the JAX and the port shard."""
    per = N // SLICES
    obs = np.repeat(world["row"][None], N, axis=0)
    mask = np.zeros((N,) + world["full"].shape, bool)
    mask[:, 0] = True
    for s in flip_slices:
        mask[s * per:(s + 1) * per] = True
    stall = np.zeros(N, np.int32)
    ja, jlp, jv = jcanary.replay_decisions(
        world["apply_fn"], world["params"], obs, mask, stall, world["jp"])
    ta, tlp, tv = tcanary.replay_decisions(world["policy"], world["inc"],
                                           obs, mask, stall, world["tp"])
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_allclose(tlp, np.asarray(jlp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-5, atol=1e-5)
    act = np.asarray(ja).copy()
    act[:corrupt] = (act[:corrupt] + 1) % 2      # a log nobody agrees with
    cols = dict(seq=0, path="<synth>", rows=N, policy_step=0,
                obs_leaves=[obs], mask_leaves=[mask], act_leaves=[act],
                log_prob=np.asarray(jlp), value=np.asarray(jv),
                stall=stall, outcome=np.zeros(N, np.int8))
    return JShard(**cols), FlightShard(**cols)


CASES = {"clean": ("inc", [], 0, "promote"),
         "regressed": ("neg", range(SLICES), 0, "blocked"),
         "one-slice": ("neg", [3], 0, "promote"),
         "two-slices": ("neg", [3, 4], 0, "blocked"),
         "bad-log": ("inc", [], 10, "promote")}


@pytest.mark.parametrize("case", list(CASES))
def test_canary_report_is_jaxs(world, case, tmp_path):
    cand, flips, corrupt, verdict = CASES[case]
    jwin, twin = _window(world, flips, corrupt)
    jreg, treg = JRegistry(), Registry()
    bus = EventBus(str(tmp_path))
    try:
        want = jcanary.run_canary(
            world["apply_fn"], world["params"],
            world["params"] if cand == "inc" else world["neg"], jwin,
            world["row"], world["full"], env_params=world["jp"],
            slices=SLICES, registry=jreg)
        got = tcanary.run_canary(
            world["policy"], world["inc"],
            world["inc"] if cand == "inc" else world["cand"], twin,
            world["row"], world["full"], env_params=world["tp"],
            slices=SLICES, registry=treg, bus=bus)
    finally:
        bus.close()
    assert got.to_json() == want.to_json()
    assert got.verdict == verdict
    if not corrupt:
        assert got.incumbent_agreement == 1.0
    if case == "regressed":
        assert got.candidate_agreement < 1.0 and got.max_regress_streak >= 2
    for name in ("flywheel_canary_runs_total",
                 "flywheel_promotions_blocked_total"):
        assert (name in treg.render()) == (name in jreg.render())
    blocked = [e for e in read_events(bus.path)
               if e["kind"] == "promote_blocked"]
    assert len(blocked) == (verdict == "blocked")


@pytest.mark.parametrize("knob", ["slices", "hysteresis"])
def test_canary_validates_its_knobs_as_jax(world, knob):
    jwin, twin = _window(world, [])
    with pytest.raises(ValueError, match=knob) as want:
        jcanary.run_canary(world["apply_fn"], world["params"],
                           world["params"], jwin, world["row"],
                           world["full"], **{knob: 0})
    with pytest.raises(ValueError, match=knob) as got:
        tcanary.run_canary(world["policy"], world["inc"], world["inc"],
                           twin, world["row"], world["full"], **{knob: 0})
    assert str(got.value) == str(want.value)


def test_action_agreement_over_heads():
    a = {"top": np.array([0, 1, 2]), "pods": np.array([[1, 1], [2, 2],
                                                        [3, 3]])}
    b = {"top": np.array([0, 1, 0]), "pods": np.array([[1, 1], [2, 0],
                                                        [3, 3]])}
    want = jcanary.action_agreement(a, b)
    np.testing.assert_array_equal(tcanary.action_agreement(a, b), want)
    np.testing.assert_array_equal(want, [True, False, False])


# ---- the watchdog ----------------------------------------------------

def _script(name):
    """(baseline p99s, [(p99, shed increment, recompiles), ...])."""
    return {
        "p99-streak": ([10.0] * 3, [(11.0, 0, 0), (100.0, 0, 0),
                                    (100.0, 0, 0)]),
        "reset": ([10.0], [(100.0, 0, 0), (10.0, 0, 0), (100.0, 0, 0)]),
        "recompile": ([10.0], [(10.0, 0, 1)]),
        "shedding": ([10.0], [(10.0, 0, 0), (10.0, 1, 0), (10.0, 1, 0)]),
        "unlearned": ([0.0], [(50.0, 0, 0), (50.0, 0, 0)]),
    }[name]


def _ticks(wd_cls, reg, script, bus=None):
    base, ticks = _script(script)
    eng = types.SimpleNamespace(post_warmup_recompiles=0)
    wd = wd_cls(reg, engine=eng, breach_after=2, bus=bus)
    g = reg.gauge("serve_decision_latency_p99_ms")
    shed = reg.counter("serve_shed_total")
    shed.inc(5)                       # pre-swap shedding is not counted
    for p in base:
        g.set(p)
        wd.sample_baseline()
    wd.arm()
    out = []
    for p99, s, rec in ticks:
        g.set(p99)
        shed.inc(s)
        eng.post_warmup_recompiles += rec
        out.append(wd.observe())
    return out, wd.baseline_p99_ms


@pytest.mark.parametrize("script", ["p99-streak", "reset", "recompile",
                                    "shedding", "unlearned"])
def test_watchdog_ticks_as_jaxs(script, tmp_path):
    bus = EventBus(str(tmp_path))
    try:
        got = _ticks(tcanary.SLOWatchdog, Registry(), script, bus)
    finally:
        bus.close()
    want = _ticks(jcanary.SLOWatchdog, JRegistry(), script)
    assert got == want
    rolled = [t for t in got[0] if t["rollback"]]
    assert bool(rolled) == (script in ("p99-streak", "recompile",
                                       "shedding"))
    kinds = [e["kind"] for e in read_events(bus.path)]
    assert kinds.count("promote_rollback") == len(rolled)


def test_watchdog_validates_as_jax():
    with pytest.raises(ValueError, match="breach_after") as want:
        jcanary.SLOWatchdog(JRegistry(), breach_after=0)
    with pytest.raises(ValueError, match="breach_after") as got:
        tcanary.SLOWatchdog(Registry(), breach_after=0)
    assert str(got.value) == str(want.value)
    # the port's breach factor and baseline forgetting factor are
    # constants, JAX's keyword defaults
    params = inspect.signature(jcanary.SLOWatchdog).parameters
    assert tcanary.P99_FACTOR == params["p99_factor"].default
    assert tcanary.EWMA_ALPHA == params["alpha"].default
    with pytest.raises(RuntimeError, match="arm"):
        tcanary.SLOWatchdog(Registry()).observe()


# ---- the ledger ------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_ledger_round_trip_and_tail_across_packages(tmp_path, writer,
                                                    reader):
    mods = {"jax": jcanary, "port": tcanary}
    d = str(tmp_path)
    led = mods[writer].PromotionLedger(d, durable=False)
    for i, ev in enumerate(("blocked", "promote", "rollback")):
        led.append({"action": ev, "window_rows": 10 * i})
    read = mods[reader].read_ledger
    sealed, tail = read(d)
    assert [e["action"] for e in sealed] == ["blocked", "promote",
                                             "rollback"]
    assert tail == []
    # an append that died before the sidecar rewrite: the unsealed tail
    with open(led.path, "a") as f:
        f.write(json.dumps({"action": "late"}) + "\n")
    sealed, tail = read(d)
    assert len(sealed) == 3 and [e["action"] for e in tail] == ["late"]
    with open(led.path, "a") as f:
        f.write('{"action": "to')         # a torn last line
    assert read(d) == mods[writer].read_ledger(d)
    assert len(read(d)[1]) == 1


def test_ledger_corrupt_prefix_and_missing(tmp_path):
    d = str(tmp_path / "l")
    led = tcanary.PromotionLedger(d)
    led.append({"action": "promote"})
    blob = bytearray(open(led.path, "rb").read())
    blob[2] ^= 0xFF
    open(led.path, "wb").write(bytes(blob))
    with pytest.raises(tcanary.LedgerCorruptError):
        tcanary.read_ledger(d)
    with pytest.raises(jcanary.LedgerCorruptError):
        jcanary.read_ledger(d)
    assert tcanary.read_ledger(str(tmp_path / "nope")) == ([], [])
    assert tcanary.LEDGER_NAME == jcanary.LEDGER_NAME


# ---- the swap --------------------------------------------------------

@pytest.mark.parametrize("surface", ["engine", "router"])
def test_swap_rewarms_without_a_build_and_rolls_back_bit_for_bit(world,
                                                                 surface):
    obs = world["obs"][:7]
    mask = np.ones((7, world["tp"].n_actions), bool)
    if surface == "engine":
        pol = make_policy("flat", world["tp"].n_actions,
                          world["tp"].obs_shape(), dtype=torch.float32,
                          device="cpu")
        pol.load_state_dict(world["inc"])
        srv = InferenceEngine(pol, max_bucket=8, device="cpu",
                              env_params=world["tp"], strict=True,
                              capture=True)
        swap = lambda sd: (srv.set_params(sd), srv.rewarm())[1]
    else:
        srv = EngineRouter(world["policy"], world["tp"], max_bucket=8,
                           strict=True, n_engines=2, device="cpu",
                           capture=True)
        swap = srv.swap_params
    warmed = srv.warmup(obs[0], mask[0])
    before, _ = srv.decide(obs, mask)
    assert swap(world["cand"]) == tuple(warmed)
    moved, _ = srv.decide(obs, mask)
    assert not np.array_equal(moved[0], before[0])
    assert swap(world["inc"]) == tuple(warmed)
    after, _ = srv.decide(obs, mask)
    for x, y in zip(before, after):
        np.testing.assert_array_equal(x, y)
    assert srv.post_warmup_recompiles == 0
    bad = dict(world["inc"])
    k = next(iter(bad))
    bad[k] = torch.zeros(3)
    with pytest.raises(ValueError, match="redeploy"):
        swap(bad)
