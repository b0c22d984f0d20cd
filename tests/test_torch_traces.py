"""The port's trace generators against the JAX package's: the same seed
gives byte-equal arrays, field by field."""
import dataclasses

import numpy as np
import pytest

from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu import experiment as jexp
from rlgpuschedule_tpu.sim import core as jcore
from rlgpuschedule_tpu.traces import gen_philly_proxy_trace as jphilly
from rlgpuschedule_tpu.traces import gen_poisson_trace as jpoisson
from rlgpuschedule_tpu_torch import configs as tconfigs
from rlgpuschedule_tpu_torch import experiment as texp
from rlgpuschedule_tpu_torch.sim import core as tcore
from rlgpuschedule_tpu_torch.traces import gen_philly_proxy_trace as tphilly
from rlgpuschedule_tpu_torch.traces import gen_poisson_trace as tpoisson

FIELDS = ("submit", "duration", "gpus", "tenant", "valid")


def _same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("seed", [0, 11])
def test_poisson_trace_is_byte_equal(seed):
    kw = dict(mean_duration=450.0, n_tenants=3, max_jobs=300)
    _same(jpoisson(0.07, 257, seed, **kw), tpoisson(0.07, 257, seed, **kw))


@pytest.mark.parametrize("seed", [0, 5])
def test_philly_proxy_trace_is_byte_equal(seed):
    kw = dict(n_gpus=512, load=1.1, max_gang=512, n_tenants=14)
    _same(jphilly(3000, seed, **kw), tphilly(3000, seed, **kw))
    kw = dict(n_gpus=32, load=1.4, max_gang=8, n_tenants=1)
    _same(jphilly(500, seed, **kw), tphilly(500, seed, **kw))


@pytest.mark.parametrize("name", ["ppo-mlp-synth64", "ppo-cnn-philly512"])
@pytest.mark.parametrize("start", [0, 37])
def test_env_windows_are_byte_equal(name, start):
    over = dict(n_envs=5, source_jobs=600, seed=3)
    cfg_j = dataclasses.replace(jconfigs.CONFIGS[name], **over)
    cfg_t = dataclasses.replace(tconfigs.CONFIGS[name], **over)
    src_j, src_t = jexp.load_source_trace(cfg_j), texp.load_source_trace(cfg_t)
    _same(src_j, src_t)
    assert (jexp.windows_per_pass(src_j.num_jobs, cfg_j.window_jobs)
            == texp.windows_per_pass(src_t.num_jobs, cfg_t.window_jobs))
    for a, b in zip(jexp.make_env_windows(cfg_j, src_j, start),
                    texp.make_env_windows(cfg_t, src_t, start)):
        _same(a, b)


def test_validate_trace_refuses_or_clamps_like_jax():
    tr = jphilly(400, 2, n_gpus=512, load=1.1, max_gang=512)
    jp, tp = jcore.SimParams(4, 8, 400), tcore.SimParams(4, 8, 400)
    with pytest.raises(ValueError, match="clamp=True"):
        tcore.validate_trace(tp, tr)
    with pytest.raises(ValueError, match="clamp=True"):
        jcore.validate_trace(jp, tr)
    got = tcore.validate_trace(tp, tr, clamp=True)
    _same(jcore.validate_trace(jp, tr, clamp=True), got)
    assert int(got.gpus.max()) == 32


def test_unported_trace_sources_are_refused():
    cfg = tconfigs.CONFIGS["a2c-pai-fair"]
    with pytest.raises(NotImplementedError, match="pai-proxy"):
        texp.load_source_trace(cfg)
    np.testing.assert_equal(
        texp.windows_per_pass(1000, 128), jexp.windows_per_pass(1000, 128))
