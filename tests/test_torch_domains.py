"""Parity of the port's domain randomization with the JAX package.

- Each regime's seeded ``DomainDraw`` and its ``DomainSchedule`` (alone
  and composed with a fault draw) are JAX's bit for bit, at three seeds;
  the validation and the stats agree.
- ``make_domain_windows`` and the experiment's per-env schedules are
  JAX's, at two streaming cursors.
- One batched episode under ``mixed`` draws composed with ``storm``
  faults, with the health and geometry channels on, is bit-identical to
  jitted JAX's at every step (state, info, mask, reward, both channels;
  the other observation features within rtol 1e-6 / atol 1e-7, the tanh
  of ``tests/test_torch_sim.py``). The ``none`` draw is the fixed
  cluster, state for state. ``OracleSim`` on a drawn geometry follows
  JAX's.
- A JAX policy whose input carries the two channels converts and acts
  the same: logits within rtol 1e-5 / atol 1e-5, the same argmax.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu import domains as jdom
from rlgpuschedule_tpu import experiment as jexp
from rlgpuschedule_tpu.env import env as jenv
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu.sim import faults as jfaults
from rlgpuschedule_tpu.sim import oracle as joracle
from rlgpuschedule_tpu_torch import configs as tconfigs
from rlgpuschedule_tpu_torch import domains as tdom
from rlgpuschedule_tpu_torch import experiment as texp
from rlgpuschedule_tpu_torch.env import env as tenv
from rlgpuschedule_tpu_torch.models import make_policy, params_from_jax
from rlgpuschedule_tpu_torch.sim import faults as tfaults
from rlgpuschedule_tpu_torch.sim import oracle as toracle

torch.set_num_threads(1)

N, G, J, K, E = 6, 4, 20, 4, 4
STEPS = 200
SMALL = dict(n_nodes=N, gpus_per_node=G, window_jobs=J, queue_len=K,
             n_envs=E, horizon=STEPS + 8)


def _draw_fields(d):
    return (d.spec_name, d.load, d.duration_scale, d.burst_frac, d.diurnal,
            d.total_gpus)


@pytest.mark.parametrize("regime", sorted(jdom.DOMAIN_REGIMES))
def test_domain_draws_and_schedules_are_jax_bit_for_bit(regime):
    for seed in (0, 4, (2, 3)):
        want = jdom.sample_domain(regime, 8, 8, seed)
        got = tdom.sample_domain(regime, 8, 8, seed)
        assert _draw_fields(got) == _draw_fields(want)
        for f in ("capacity", "slowdown"):
            x, y = getattr(want, f), getattr(got, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(y, x, f)
        assert tdom.domain_stats(got) == jdom.domain_stats(want)
        storm = (jfaults.sample_fault_schedule(8, "storm", seed, 500.0),
                 tfaults.sample_fault_schedule(8, "storm", seed, 500.0))
        for jf, tf in ((None, None), storm):
            ws = jdom.validate_domain_schedule(
                8, 8, jdom.domain_schedule(want, jf))
            ts = tdom.validate_domain_schedule(
                8, 8, tdom.domain_schedule(got, tf))
            for f in ws._fields:
                x, y = np.asarray(getattr(ws, f)), getattr(ts, f)
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(y, x, f)


def test_validation_matches_jax():
    draw = tdom.sample_domain("geom", 4, 8, 1)
    good = tdom.domain_schedule(draw)
    for bad in (good._replace(capacity=np.full(4, 9, np.int32)),
                good._replace(capacity=np.zeros(4, np.int32)),
                good._replace(capacity=np.ones(4, np.float32)),
                good._replace(capacity=np.ones(3, np.int32))):
        with pytest.raises(ValueError) as je:
            jdom.validate_domain_schedule(
                4, 8, jdom.DomainSchedule(*bad))
        with pytest.raises(ValueError) as te:
            tdom.validate_domain_schedule(4, 8, bad)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="unknown domain regime"):
        tdom.resolve_domain("moon")
    with pytest.raises(ValueError, match="p_node_off"):
        tdom.DomainSpec("x", p_node_off=1.5)


@pytest.mark.parametrize("cursor", [0, 8])
def test_domain_windows_and_schedules_are_jax(cursor):
    kw = dict(SMALL, domains="mixed", faults="storm", drain_frac=0.25)
    jcfg = dataclasses.replace(jconfigs.CONFIGS["ppo-mlp-synth64"], **kw)
    tcfg = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"], **kw)
    jd = jdom.sample_env_domains("mixed", N, G, 0, E)
    td = tdom.sample_env_domains("mixed", N, G, 0, E)
    want = jexp.make_domain_windows(jcfg, jd, cursor)
    got = texp.make_domain_windows(tcfg, td, cursor)
    for w, g in zip(want, got):
        for f in ("submit", "duration", "gpus", "tenant", "valid"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), f)
    # the schedules the experiment draws for its envs, as JAX's build
    tp = texp.build_env_params(tcfg)
    assert tp.fault_obs and tp.domain_obs
    assert tp.obs_shape() == jexp.build_env_params(jcfg).obs_shape()
    faults, draws = texp.draw_schedules(tcfg, tp, got, "cpu")
    horizon = jfaults.fault_horizon(want)
    for e, d in enumerate(jd):
        js = jdom.validate_domain_schedule(N, G, jdom.domain_schedule(
            d, jfaults.sample_fault_schedule(N, "storm", (0, e), horizon)))
        for f in js._fields:
            np.testing.assert_array_equal(getattr(faults, f)[e].numpy(),
                                          np.asarray(getattr(js, f)), f)
        assert _draw_fields(draws[e]) == _draw_fields(d)


def _check(step, jst, jts, tst, tts):
    for name in jst.sim._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jst.sim, name)),
                                      getattr(tst.sim, name).numpy(),
                                      err_msg=f"step {step} {name}")
    for name in jts.info._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jts.info, name)),
                                      getattr(tts.info, name).numpy(),
                                      err_msg=f"step {step} {name}")
    for name in ("action_mask", "done", "reward"):
        np.testing.assert_array_equal(np.asarray(getattr(jts, name)),
                                      getattr(tts, name).numpy(),
                                      err_msg=f"step {step} {name}")
    jo, to = np.asarray(jts.obs), tts.obs.numpy()
    np.testing.assert_array_equal(to[:, -2 * N:], jo[:, -2 * N:],
                                  err_msg=f"step {step} channels")
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-7,
                               err_msg=f"step {step} obs")


@pytest.fixture(scope="module")
def world():
    """Config 1 cut small under mixed domains and storm faults, built by
    both packages' window and schedule code, and its env params."""
    kw = dict(SMALL, domains="mixed", faults="storm")
    jcfg = dataclasses.replace(jconfigs.CONFIGS["ppo-mlp-synth64"], **kw)
    tcfg = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"], **kw)
    jp, tp = jexp.build_env_params(jcfg), texp.build_env_params(tcfg)
    windows = texp.make_domain_windows(
        tcfg, tdom.sample_env_domains("mixed", N, G, 0, E))
    tf, _ = texp.draw_schedules(tcfg, tp, windows, "cpu")
    jf = jdom.DomainSchedule(*(jnp.asarray(x.numpy()) for x in tf))
    return jp, tp, windows, jf, tf


def test_episode_under_mixed_domains_is_jax_bit_for_bit(world):
    jp, tp, windows, jf, tf = world
    jtr = jenv.stack_traces(windows, jp)
    ttr = tenv.stack_traces(windows, tp, device="cpu")
    jst, jts = jax.jit(lambda tr, f: jenv.vec_reset(jp, tr, f))(jtr, jf)
    tst, tts = tenv.vec_reset(tp, ttr, tf)
    _check(-1, jst, jts, tst, tts)
    np.testing.assert_array_equal(tst.sim.free.numpy(), tf.capacity.numpy())
    jstep = jax.jit(jax.vmap(lambda s, tr, a, f: jenv.step(jp, s, tr, a, f)))
    rng = np.random.default_rng(2)
    for i in range(STEPS):
        m = np.asarray(jts.action_mask)
        a = np.array([rng.choice(np.flatnonzero(r)) for r in m], np.int32)
        jst, jts = jstep(jst, jtr, jnp.asarray(a), jf)
        tst, tts = tenv.step(tp, tst, ttr, torch.from_numpy(a), tf)
        _check(i, jst, jts, tst, tts)
        alloc, free = tst.sim.alloc.numpy(), tst.sim.free.numpy()
        np.testing.assert_array_equal(alloc.sum(1) + free,
                                      tf.capacity.numpy())
        if bool(np.asarray(jts.done).all()):
            break
    assert bool(np.asarray(jts.info.done).any()), "no episode finished"
    assert (tf.capacity.numpy() < G).any() and \
        (tf.slowdown.numpy() > 1).any()


def test_the_none_draw_is_the_fixed_cluster(world):
    _, tp, windows, _, _ = world
    ttr = tenv.stack_traces(windows, tp, device="cpu")
    none = tdom.stack_domain_schedules(
        [tdom.domain_schedule(d)
         for d in tdom.sample_env_domains("none", N, G, 0, E)], "cpu")
    flat = dataclasses.replace(tp, fault_obs=False, domain_obs=False)
    ast, ats = tenv.vec_reset(tp, ttr, none)
    bst, bts = tenv.vec_reset(flat, ttr)
    rng = np.random.default_rng(4)
    for i in range(60):
        assert all(torch.equal(x, y) for x, y in zip(ast.sim, bst.sim)), i
        assert torch.equal(ats.obs[:, :-2 * N], bts.obs), i
        assert bool((ats.obs[:, -2 * N:] == 1).all()), i
        assert torch.equal(ats.action_mask, bts.action_mask), i
        assert torch.equal(ats.reward, bts.reward), i
        a = torch.tensor([rng.choice(np.flatnonzero(r))
                          for r in bts.action_mask.numpy()],
                         dtype=torch.int32)
        ast, ats = tenv.step(tp, ast, ttr, a, none)
        bst, bts = tenv.step(flat, bst, ttr, a)


def test_oracle_on_a_drawn_geometry_follows_jax(world):
    _, _, windows, _, tf = world
    rng = np.random.default_rng(6)
    for e, w in enumerate(windows):
        sched = tdom.DomainSchedule(*(x[e].numpy() for x in tf))
        js = joracle.OracleSim(w, N, G, faults=jdom.DomainSchedule(*sched))
        ts = toracle.OracleSim(w, N, G, faults=sched)
        assert ts.capacity == js.capacity < N * G
        for i, a in enumerate(rng.integers(0, K + 1, size=400)):
            assert ts.rl_step(int(a), K) == js.rl_step(int(a), K), i
            for f in ("status", "remaining", "alloc", "free"):
                np.testing.assert_array_equal(getattr(ts, f),
                                              getattr(js, f), f"{i} {f}")
            assert ts.gpus_consistent()
            if js.done():
                break
        np.testing.assert_array_equal(ts.jcts(), js.jcts())


def test_a_policy_with_both_channels_converts_and_acts_the_same(world):
    jp, tp, windows, jf, tf = world
    ttr = tenv.stack_traces(windows, tp, device="cpu")
    _, ts = tenv.vec_reset(tp, ttr, tf)
    obs, mask = ts.obs.numpy(), ts.action_mask.numpy()
    assert obs.shape[1] == jp.obs_shape()[0] == 2 * N + N + 4 * K + 2
    jnet = jmake_policy("flat", jp.n_actions, dtype=jnp.float32)
    params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(1), obs,
                                               mask))
    jl, jv = jax.jit(jnet.apply)(params, obs, mask)
    net = make_policy("flat", tp.n_actions, tp.obs_shape(),
                      dtype=torch.float32, device="cpu")
    net.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        tl, tv = net(ts.obs, ts.action_mask)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))


def test_refusals_match_jax():
    hier = dataclasses.replace(tconfigs.CONFIGS["hier-pbt-member"],
                               domains="mixed")
    with pytest.raises(ValueError, match="no domain-randomization"):
        texp.build_env_params(hier)
    with pytest.raises(ValueError, match="no fault-process"):
        texp.build_env_params(dataclasses.replace(hier, domains=None,
                                                  faults="storm"))
    pbt = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"], **SMALL,
                              domains="mixed")
    with pytest.raises(ValueError, match="does not thread domain"):
        texp.PopulationExperiment.build(pbt, n_pop=2, device="cpu")
    with pytest.raises(tconfigs.ModeCombinationError, match="--domains"):
        tconfigs.validate_mode_combination({"pbt": True, "domains": True})
    grid = texp.build_env_params(dataclasses.replace(
        tconfigs.CONFIGS["ppo-cnn-philly512"], faults="storm",
        domains="geom"))
    assert not grid.fault_obs and not grid.domain_obs
