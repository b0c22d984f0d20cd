"""Window streaming and the drain curriculum of the port against the JAX
package's.

- ``load_source_trace(n_jobs=, seed=)``, ``drain_window`` and
  ``make_env_windows`` (``drain_frac`` 0, 0.25 and 1, several cursors,
  wrapping past the trace's end) give JAX's arrays on every field, byte
  for byte.
- ``Experiment.advance_windows`` re-cuts the same windows as JAX's at
  every resample, and ``run`` resamples on JAX's schedule.
- A streaming rollout fed the JAX rollout's sampled actions gives JAX's
  transitions across a resample boundary: mask, reward, done and the
  simulated ``dt`` identical, the observations within the env tolerance
  of ``tests/test_torch_sim.py`` (rtol 1e-6, atol 1e-7), log-probs and
  values within 1e-5, on integer-valued traces with half the envs
  drained.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu import experiment as jexp
from rlgpuschedule_tpu.algos import ppo as jppo
from rlgpuschedule_tpu.algos.rollout import init_carry as jinit_carry
from rlgpuschedule_tpu.algos.rollout import rollout as jrollout
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu_torch import configs as tconfigs
from rlgpuschedule_tpu_torch import experiment as texp
from rlgpuschedule_tpu_torch.algos import action_dist as tdist
from rlgpuschedule_tpu_torch.algos.rollout import init_carry, rollout
from rlgpuschedule_tpu_torch.models import params_from_jax
from torch_jax_builds import fast_jax_build, jitted_reference

# the tensors here are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("submit", "duration", "gpus", "tenant", "valid")
SMALL = dict(n_envs=4, n_nodes=4, gpus_per_node=4, window_jobs=12,
             queue_len=4, horizon=96)
T = 16


def _both(name="ppo-mlp-synth64", **kw):
    return (dataclasses.replace(jconfigs.CONFIGS[name], **kw),
            dataclasses.replace(tconfigs.CONFIGS[name], **kw))


def _assert_bytes(want, got, what=""):
    for f in FIELDS:
        a, b = np.asarray(getattr(want, f)), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert a.tobytes() == b.tobytes(), (what, f)


@pytest.mark.parametrize("name", ["ppo-mlp-synth64", "ppo-cnn-philly512",
                                  "a2c-pai-fair"])
@pytest.mark.parametrize("n_jobs,seed", [(None, None), (300, 7)])
def test_load_source_trace_matches_jax(name, n_jobs, seed):
    cj, ct = _both(name)
    _assert_bytes(jexp.load_source_trace(cj, n_jobs=n_jobs, seed=seed),
                  texp.load_source_trace(ct, n_jobs=n_jobs, seed=seed))


def test_load_source_trace_caps_a_csv_like_jax():
    csv = os.path.join(ROOT, "tests", "fixtures", "philly_small.csv")
    cj, ct = _both(trace="philly", trace_path=csv)
    for n in (None, 5):
        _assert_bytes(jexp.load_source_trace(cj, n_jobs=n),
                      texp.load_source_trace(ct, n_jobs=n))
    assert texp.load_source_trace(ct, n_jobs=5).num_jobs == 5


def test_drain_window_matches_jax():
    cj, ct = _both()
    wj = jexp.load_source_trace(cj).slice(100, 64)
    wt = texp.load_source_trace(ct).slice(100, 64)
    _assert_bytes(jexp.drain_window(wj), texp.drain_window(wt))
    d = texp.drain_window(wt)
    assert (d.submit[d.valid] == 0.0).all()
    assert np.isinf(d.submit[~d.valid]).all()


@pytest.mark.parametrize("drain_frac", [0.0, 0.25, 1.0])
@pytest.mark.parametrize("start", [0, 3, 17, 260])
def test_make_env_windows_matches_jax(drain_frac, start):
    cj, ct = _both(n_envs=4, window_jobs=16, drain_frac=drain_frac)
    sj = jexp.load_source_trace(cj, n_jobs=100)    # not a multiple of 16
    st = texp.load_source_trace(ct, n_jobs=100)
    wj = jexp.make_env_windows(cj, sj, start)
    wt = texp.make_env_windows(ct, st, start)
    assert len(wt) == 4
    for e, (a, b) in enumerate(zip(wj, wt)):
        _assert_bytes(a, b, e)
        drained = bool((b.submit[b.valid] == 0.0).all())
        assert drained == (e >= 4 - int(round(4 * drain_frac))), e


def test_run_resamples_on_jax_schedule():
    """One ``run`` of 5 iterations with a resample every 2 re-cuts the
    windows before iterations 2 and 4 in both packages: the same cursor
    and the same windows at the end. JAX's loop runs with a train step
    that hands the state back unchanged: the schedule is its loop's, and
    compiling its PPO step would be most of this test's time."""
    ppo_j = dataclasses.replace(jconfigs.CONFIGS["ppo-mlp-synth64"].ppo,
                                n_steps=4, n_epochs=1, n_minibatches=1)
    ppo_t = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"].ppo,
                                n_steps=4, n_epochs=1, n_minibatches=1)
    cj, ct = _both(**SMALL, resample_every=2, drain_frac=0.5)
    ej = fast_jax_build(dataclasses.replace(cj, ppo=ppo_j))
    zero = jppo.PPOMetrics(*([np.float32(0)] * len(jppo.PPOMetrics._fields)))
    ej.train_step = lambda state, carry, traces, key, *faults: (state, carry,
                                                                zero)
    et = texp.Experiment.build(dataclasses.replace(ct, ppo=ppo_t),
                               device="cpu")
    with jitted_reference():
        assert ej.run(5)["window_cursor"] == et.run(5)["window_cursor"] == 8
    for a, b in zip(ej.windows, et.windows):
        _assert_bytes(a, b)
    for _ in range(2):
        ej.advance_windows()
        et.advance_windows()
        assert et.window_cursor == ej.window_cursor
        for a, b in zip(ej.windows, et.windows):
            _assert_bytes(a, b)


def _integer(tr):
    """``tr`` with integer submit times and durations (exact in f32)."""
    return dataclasses.replace(
        tr, submit=np.where(tr.valid, np.round(tr.submit),
                            np.inf).astype(np.float32),
        duration=np.maximum(np.round(tr.duration), 1.0).astype(np.float32))


def test_streaming_rollout_replays_jax_actions_across_a_resample():
    cj, ct = _both(**SMALL, resample_every=1, drain_frac=0.5)
    ej = fast_jax_build(cj)
    et = texp.Experiment.build(ct, device="cpu")
    jp, tp = ej.env_params, et.env_params
    ej.source = _integer(ej.source)
    et.source = _integer(et.source)
    ej._cut_windows(0)
    et._cut_windows(0)
    ej.carry = jinit_carry(jp, ej.traces, jax.random.PRNGKey(5))
    et.carry = init_carry(tp, et.traces, et.carry.generator)

    net = jmake_policy("flat", jp.n_actions, dtype=jnp.float32)
    params = jax.device_get(jax.jit(net.init)(
        jax.random.PRNGKey(2), jnp.zeros((1,) + jp.obs_shape()),
        jnp.ones((1, jp.n_actions), bool)))
    jroll = jax.jit(lambda p, c, tr: jrollout(
        lambda q, o, m: net.apply(q, o, m), p, jp, tr, c, T))
    policy = texp.build_policy(ct, tp, dtype=torch.float32, device="cpu")
    policy.load_state_dict(params_from_jax(params))

    for leg in range(2):
        for a, b in zip(ej.windows, et.windows):
            _assert_bytes(a, b, leg)
        _, jtr, jlast = jroll(params, ej.carry, ej.traces)
        actions = iter(torch.tensor(np.asarray(jtr.action)))

        def replay(_gen, logits):
            a = next(actions)
            return a, tdist.log_prob(logits, a)

        _, tr, last = rollout(policy, tp, et.traces, et.carry, T,
                              sample_fn=replay)
        for f in ("action", "reward", "done", "mask", "env_steps_dt"):
            np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                          np.asarray(getattr(jtr, f)),
                                          err_msg=f"{f}, leg {leg}")
        np.testing.assert_allclose(tr.obs.numpy(), np.asarray(jtr.obs),
                                   rtol=1e-6, atol=1e-7)
        for got, want in ((tr.log_prob, jtr.log_prob),
                          (tr.value, jtr.value), (last, jlast)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        assert bool(np.asarray(jtr.env_steps_dt).any())
        # the resample: both packages re-cut at the next n_envs windows
        # and reset every episode
        ej.advance_windows()
        et.advance_windows()
        assert et.window_cursor == ej.window_cursor == 4 * (leg + 1)
