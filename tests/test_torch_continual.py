"""The port's continual training (``flywheel/continual.py``) against the
JAX package's, on the same logged shards and converted f32 weights.

- ``admit_shards``: the per-shard report (staleness, verdicts, ratios
  within 1e-6): an on-policy log all admitted, shards pushed 4 nats off
  refused, a mixed log admitted shard by shard; the gauges and counters.
- ``gate_logged_mask`` is the engine's stall gate on the preempt preset,
  and the ratios are 1 only under the replayed gate.
- ``shards_to_transition``: ``T``, the dropped tail and every field,
  element for element.
- One continual learn step on JAX's permutation within the learn-step
  tolerance (atol 1e-5) of JAX's ``run_continual``; the port's
  ``run_continual`` summary against JAX's.
- The empty (or missing) log and the trust knob are refused.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu.algos import ppo as jppo
from rlgpuschedule_tpu.experiment import build_env_params as jbuild
from rlgpuschedule_tpu.flywheel import canary as jcanary
from rlgpuschedule_tpu.flywheel import continual as jcont
from rlgpuschedule_tpu.flywheel import flightlog as jfl
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu.obs import Registry as JRegistry
from rlgpuschedule_tpu_torch import configs as tconfigs
from rlgpuschedule_tpu_torch.algos import ppo as tppo
from rlgpuschedule_tpu_torch.decision import stall_threshold
from rlgpuschedule_tpu_torch.experiment import Experiment
from rlgpuschedule_tpu_torch.flywheel import continual as tcont
from rlgpuschedule_tpu_torch.flywheel import flightlog as tfl
from rlgpuschedule_tpu_torch.flywheel.flightlog import (FlightLogError,
                                                        FlightLogWriter,
                                                        FlightShard)
from rlgpuschedule_tpu_torch.models import make_policy, params_from_jax
from rlgpuschedule_tpu_torch.obs import Registry

torch.set_num_threads(1)

SMALL = dict(n_envs=2, window_jobs=12, horizon=96, n_nodes=4,
             gpus_per_node=4, queue_len=4, preempt_len=2)
PPO = dict(n_steps=8, n_epochs=1, n_minibatches=2)
ROWS = 64


def _cfg(mod):
    base = mod.CONFIGS["ppo-mlp-synth64"]
    return dataclasses.replace(base, **SMALL, ppo=dataclasses.replace(
        base.ppo, **PPO))


@pytest.fixture(scope="module")
def world():
    """Config 1 cut small (preempt slots on) with an f32 policy: JAX's
    net and weights, the port's twin, 64 seeded request rows and their
    on-policy behavior columns (JAX's gated replay)."""
    jcfg, tcfg = _cfg(jconfigs), _cfg(tconfigs)
    jp = jbuild(jcfg)
    net = jmake_policy("flat", jp.n_actions, dtype=jnp.float32)
    params = jax.device_get(jax.jit(net.init)(
        jax.random.PRNGKey(0), jnp.zeros((1,) + jp.obs_shape()),
        jnp.ones((1, jp.n_actions), bool)))
    # jitted: JAX's admission applies the net eagerly, op by op
    apply_fn = jax.jit(lambda p, o, m: net.apply(p, o, m))
    texp = Experiment.build(tcfg, device="cpu")
    tp = texp.env_params
    rng = np.random.default_rng(3)
    obs = rng.standard_normal((ROWS,) + tp.obs_shape()).astype(np.float32)
    mask = rng.random((ROWS, tp.n_actions)) < 0.6
    mask[:, -1] = True
    stall = np.zeros(ROWS, np.int32)
    act, lp, val = jcanary.replay_decisions(apply_fn, params, obs, mask,
                                            stall, jp)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, net=net, params=params,
                apply_fn=apply_fn, texp=texp, obs=obs, mask=mask,
                stall=stall, act=np.asarray(act), lp=np.asarray(lp),
                val=np.asarray(val))


def _policy(world):
    pol = make_policy("flat", world["tp"].n_actions,
                      world["tp"].obs_shape(), dtype=torch.float32,
                      device="cpu")
    pol.load_state_dict(params_from_jax(world["params"]))
    return pol


def _log(world, d, shifts=(0.0,), capacity=16, outcome=1, n=ROWS):
    """One append per entry of ``shifts``: the rows with their stored
    behavior log-probs moved by that many nats."""
    with FlightLogWriter(d, capacity=capacity, policy_step=0) as w:
        for s in shifts:
            oc = np.full(n, outcome, np.int8)
            oc[::5] = 2                         # some served late
            w.append_batch(world["obs"][:n], world["mask"][:n],
                           world["act"][:n], world["lp"][:n] + s,
                           world["val"][:n], world["stall"][:n], oc)
    return d


def _examples(world):
    return world["obs"][:1], world["mask"][:1], world["act"][:1]


@pytest.mark.parametrize("case,shifts,accepted", [
    ("on-policy", (0.0,), 4), ("off-policy", (4.0,), 0),
    ("mixed", (0.0, 4.0), 4)])
def test_admission_report_is_jaxs(world, tmp_path, case, shifts, accepted):
    d = _log(world, str(tmp_path), shifts)
    jreg, treg = JRegistry(), Registry()
    ja, jrep = jcont.admit_shards(
        jfl.read_flight_log(d), world["apply_fn"], world["params"], 3,
        *_examples(world), registry=jreg, env_params=world["jp"])
    ta, trep = tcont.admit_shards(
        tfl.read_flight_log(d), _policy(world), 3, *_examples(world),
        registry=treg, env_params=world["tp"])
    assert trep.shards_accepted == jrep.shards_accepted == accepted
    for k in ("shards_seen", "shards_refused", "rows_accepted",
              "torn_tail"):
        assert getattr(trep, k) == getattr(jrep, k), k
    assert [s.seq for s in ta] == [s.seq for s in ja]
    for got, want in zip(trep.per_shard, jrep.per_shard):
        for k in ("seq", "rows", "staleness", "accepted"):
            assert got[k] == want[k], k
        np.testing.assert_allclose([got["rho_mean"], got["rho_max"]],
                                   [want["rho_mean"], want["rho_max"]],
                                   rtol=1e-6)
    assert trep.per_shard[0]["staleness"] == 3
    for name in ("flywheel_shards_ingested_total",
                 "flywheel_shards_refused_total"):
        assert (treg.counter(name).value
                == float(jreg.counter(name).value))


def test_the_trust_region_bounds(world, tmp_path):
    d = _log(world, str(tmp_path), (0.5,))      # rho about e^-0.5
    pol = _policy(world)
    data = tfl.read_flight_log(d)
    for trust, ok in ((2.0, True), (1.5, False)):
        _, rep = tcont.admit_shards(data, pol, 0, *_examples(world),
                                    trust=trust, env_params=world["tp"])
        assert rep.shards_accepted == (4 if ok else 0)
    _, rep = tcont.admit_shards(data, pol, 0, *_examples(world),
                                rho_max_cap=0.5, env_params=world["tp"])
    assert rep.shards_refused == 4
    with pytest.raises(ValueError, match="trust"):
        tcont.admit_shards(data, pol, 0, *_examples(world), trust=0.5)


def test_gate_logged_mask_is_the_engine_gate(world):
    thresh = stall_threshold(world["tp"])
    mask = np.ones((4, world["tp"].n_actions), bool)
    stall = np.asarray([thresh, 0, thresh + 3, 1], np.int32)
    got = tcont.gate_logged_mask(mask, stall, world["tp"])
    want = jcont.gate_logged_mask(mask, stall, world["jp"])
    np.testing.assert_array_equal(got, want)
    assert not got[0].all() and got[1].all()
    np.testing.assert_array_equal(tcont.gate_logged_mask(mask, stall, None),
                                  mask)


def test_rho_is_one_only_under_the_replayed_gate(world):
    thresh = stall_threshold(world["tp"])
    obs = world["obs"][:16]
    mask = np.ones((16, world["tp"].n_actions), bool)   # preempts live
    stall = np.full(16, thresh, np.int32)               # the gate fires
    act, lp, val = jcanary.replay_decisions(
        world["apply_fn"], world["params"], obs, mask, stall, world["jp"])
    shard = FlightShard(seq=0, path="<mem>", rows=16, policy_step=0,
                        obs_leaves=[obs], mask_leaves=[mask],
                        act_leaves=[np.asarray(act)],
                        log_prob=np.asarray(lp), value=np.asarray(val),
                        stall=stall, outcome=np.zeros(16, np.int8))
    pol = _policy(world)
    ex = (obs[:1], mask[:1], np.asarray(act)[:1])
    gated = tcont.shard_rho_stats(pol, shard, *ex, env_params=world["tp"])
    np.testing.assert_allclose(gated, 1.0, rtol=1e-6)
    raw, _ = tcont.shard_rho_stats(pol, shard, *ex)
    assert abs(raw - 1.0) > 1e-3
    want, _ = jcont.shard_rho_stats(world["apply_fn"], world["params"],
                                    shard, *ex)
    np.testing.assert_allclose(raw, want, rtol=1e-6)


@pytest.mark.parametrize("n,tile", [(ROWS, 2), (59, 2), (59, 4)])
def test_shards_to_transition_is_jaxs(world, tmp_path, n, tile):
    d = _log(world, str(tmp_path), capacity=16, n=n)
    stall = np.zeros(n, np.int32)
    stall[::3] = stall_threshold(world["tp"])
    jd, td = jfl.read_flight_log(d), tfl.read_flight_log(d)
    for data in (jd, td):
        for s, lo in zip(data.shards, range(0, n, 16)):
            s.stall = stall[lo:lo + s.rows]
            s.mask_leaves = [np.ones_like(x) for x in s.mask_leaves]
    jtr, jlast, jT = jcont.shards_to_transition(
        jd.shards, 2, tile, *_examples(world), env_params=world["jp"])
    ttr, tlast, tT = tcont.shards_to_transition(
        td.shards, 2, tile, *_examples(world), env_params=world["tp"])
    assert tT == jT and tT * 2 <= n and (tT * 2) % tile == 0
    assert (tT + 1) * 2 > n or ((tT + 1) * 2) % tile
    for name, got, want in zip(ttr._fields, ttr, jtr):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    assert (ttr.reward.numpy() == -1).any() and not ttr.mask.numpy().all()
    with pytest.raises(FlightLogError, match="no shards"):
        tcont.shards_to_transition([], 2, tile, *_examples(world))
    with pytest.raises(FlightLogError, match="pseudo-steps"):
        tcont.shards_to_transition(td.shards[-1:], 2, 64,
                                   *_examples(world))


def _jax_exp(world):
    """What JAX's ``run_continual`` reads of an experiment, with the f32
    policy: a fresh train state, a key, the carry's example rows."""
    cfg = world["jcfg"]
    state = jppo.TrainState.create(apply_fn=world["net"].apply,
                                   params=world["params"],
                                   tx=jppo.make_optimizer(cfg.ppo))
    return types.SimpleNamespace(
        cfg=cfg, env_params=world["jp"], apply_fn=world["apply_fn"],
        train_state=state, key=jax.random.PRNGKey(5),
        carry=types.SimpleNamespace(obs=world["obs"][:2],
                                    mask=world["mask"][:2]))


def test_one_continual_learn_step_is_jaxs(world, tmp_path):
    d = _log(world, str(tmp_path), (0.0, 4.0))
    jexp = _jax_exp(world)
    _, key = jax.random.split(jexp.key)
    jsum = jcont.run_continual(jexp, d, iterations=1, registry=JRegistry())

    # the port's pieces on JAX's permutation
    pol = _policy(world)
    tcfg = world["tcfg"]
    state = tppo.make_train_state(pol, tcfg.ppo)
    accepted, _ = tcont.admit_shards(tfl.read_flight_log(d), pol, 0,
                                     *_examples(world),
                                     env_params=world["tp"])
    tr, last, T = tcont.shards_to_transition(
        accepted, tcfg.n_envs, tcfg.ppo.n_minibatches, *_examples(world),
        env_params=world["tp"])
    algo = dataclasses.replace(tcfg.ppo, correction="vtrace", n_steps=T)
    perms = []
    k = key
    for _ in range(algo.n_epochs):
        k, sub = jax.random.split(k)
        perms.append(torch.tensor(np.asarray(
            jax.random.permutation(sub, T * tcfg.n_envs))))
    state, m = tppo.make_learn_step(algo)(state, tr, last, perms=perms)
    want = params_from_jax(jax.device_get(jexp.train_state.params))
    for name, p in pol.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(m.total_loss), jsum["total_loss"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        [float(m.rho_mean), float(m.rho_max)],
        [jsum["rho_mean_trained"], jsum["rho_max_trained"]], rtol=1e-6)

    # the port's whole loop (its own generator's permutation) on a
    # fresh f32 learner: the same summary but the loss
    texp = world["texp"]
    texp.train_state = tppo.make_train_state(_policy(world), tcfg.ppo)
    texp.carry = texp.carry._replace(
        obs=torch.from_numpy(world["obs"][:2]),
        mask=torch.from_numpy(world["mask"][:2]))
    reg = Registry()
    tsum = tcont.run_continual(texp, d, iterations=1, registry=reg)
    for k_ in ("mode", "iterations", "rows_logged", "rows_accepted",
               "rows_trained", "rows_dropped_fold", "shards_seen",
               "shards_accepted", "shards_refused", "torn_tail",
               "pseudo_steps", "final_step"):
        assert tsum[k_] == jsum[k_], k_
    assert tsum["final_step"] == 2 and tsum["shards_refused"] == 4
    assert np.isfinite(tsum["total_loss"])
    assert "flywheel_shards_refused_total 4" in reg.render()


def test_the_empty_log_and_the_trust_knob_are_refused(world, tmp_path):
    texp = world["texp"]
    for d in (str(tmp_path), str(tmp_path / "missing")):
        with pytest.raises(FlightLogError, match="no verified shards"):
            tcont.run_continual(texp, d)
    d = _log(world, str(tmp_path / "f"), capacity=8, n=8)
    with pytest.raises(ValueError, match="trust"):
        tcont.run_continual(texp, d, trust=0.5)
