"""The port's workload fits (``traces/fit.py``) and the chaos soak's
paced gaps against the JAX package's, bit for bit.

For every preset of both packages, ``domain_fit`` gives the same fit,
``gen_domain_window`` the same arrays under each arrival knob (plain,
diurnal, a flash crowd, a capped gang size, a scaled duration, a tuple
seed), and ``fit_paced_gaps`` the same gaps. ``fit_jobs`` and
``fit_hourly_curve`` fit the same numbers from the same records, and a
bad fit or knob is refused as JAX refuses it. Numpy only: no JAX
compile."""
import dataclasses

import numpy as np
import pytest

from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu.serve.bench import fit_paced_gaps as jgaps
from rlgpuschedule_tpu.traces import fit as jfit
from rlgpuschedule_tpu.traces import gen_philly_proxy_jobs as jphilly
from rlgpuschedule_tpu_torch import configs as tconfigs
from rlgpuschedule_tpu_torch.serve.bench import fit_paced_gaps as tgaps
from rlgpuschedule_tpu_torch.traces import fit as tfit
from rlgpuschedule_tpu_torch.traces import gen_philly_proxy_jobs as tphilly

PRESETS = sorted(tconfigs.CONFIGS)
KNOBS = {
    "plain": dict(n_gpus=64, load=1.0),
    "diurnal": dict(n_gpus=512, load=1.1, diurnal=True),
    "burst": dict(n_gpus=128, load=0.9, burst_frac=0.25),
    "capped": dict(n_gpus=16, load=1.2, max_gang=4, n_tenants=3),
    "scaled": dict(n_gpus=32, load=0.7, duration_scale=2.5),
}


def _fits(name):
    return (jfit.domain_fit(jconfigs.CONFIGS[name]),
            tfit.domain_fit(tconfigs.CONFIGS[name]))


def test_presets_are_the_same_in_both_packages():
    assert set(PRESETS) <= set(jconfigs.CONFIGS)


@pytest.mark.parametrize("name", PRESETS)
def test_domain_fit_matches_jax(name):
    j, t = _fits(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.mean_gpus == j.mean_gpus
    assert t.mean_duration(1.7) == j.mean_duration(1.7)


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("name", PRESETS)
def test_gen_domain_window_matches_jax_bit_for_bit(name, knob):
    j, t = _fits(name)
    for seed in (3, (0, 2, 7)):
        jw = jfit.gen_domain_window(j, 96, seed=seed, **KNOBS[knob])
        tw = tfit.gen_domain_window(t, 96, seed=seed, **KNOBS[knob])
        for field in dataclasses.fields(jw):
            a = np.asarray(getattr(jw, field.name))
            b = np.asarray(getattr(tw, field.name))
            assert a.dtype == b.dtype, field.name
            np.testing.assert_array_equal(b, a, err_msg=field.name)


@pytest.mark.parametrize("name", PRESETS)
def test_fit_paced_gaps_match_jax_bit_for_bit(name):
    j, t = _fits(name)
    for rate in (150.0, 2000.0):
        want = jgaps(j, 512, seed=(0, 0xC7A05), rate_hz=rate)
        got = tgaps(t, 512, seed=(0, 0xC7A05), rate_hz=rate)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
        assert got.mean() == pytest.approx(1.0 / rate, rel=1e-12)
    for bad in (dict(n=0, rate_hz=1.0), dict(n=4, rate_hz=0.0)):
        with pytest.raises(ValueError):
            tgaps(t, seed=0, **bad)


def test_fit_jobs_and_hourly_curve_match_jax():
    jjobs = jphilly(400, seed=5)
    tjobs = tphilly(400, seed=5)
    assert [dataclasses.astuple(x) for x in tjobs] == \
        [dataclasses.astuple(x) for x in jjobs]
    assert dataclasses.asdict(tfit.fit_jobs(tjobs, "p")) == \
        dataclasses.asdict(jfit.fit_jobs(jjobs, "p"))
    submit = np.asarray([j.submit for j in tjobs]) * 40.0
    assert tfit.fit_hourly_curve(submit) == jfit.fit_hourly_curve(submit)
    with pytest.raises(ValueError, match="zero arrivals"):
        tfit.fit_hourly_curve([])


@pytest.mark.parametrize("kw,match", [
    (dict(sigma=-1.0), "sigma"), (dict(median_duration_s=0.0), "median"),
    (dict(gpu_sizes=(1, 2), gpu_probs=(1.0,)), "matched"),
    (dict(n_tenants=0), "n_tenants"), (dict(hourly=(1.0,) * 5), "24")])
def test_bad_fits_and_knobs_are_refused(kw, match):
    base = dict(name="x", median_duration_s=10.0, sigma=1.0,
                gpu_sizes=(1,), gpu_probs=(1.0,))
    with pytest.raises(ValueError, match=match):
        tfit.TraceFit(**{**base, **kw})
    fit = tfit.TraceFit(**base)
    for bad, m in ((dict(load=0.0), "load"), (dict(burst_frac=2.0),
                                              "burst_frac")):
        with pytest.raises(ValueError, match=m):
            tfit.gen_domain_window(fit, 8, seed=0, n_gpus=8,
                                   **{"load": 1.0, **bad})
