"""Workload-distribution fits and fitted window generation (L0) of the
port.

A numpy copy of the JAX package's ``traces/fit.py``: :class:`TraceFit`
summarizes a workload (log-normal duration body, gang-size histogram,
tenant count, hour-of-day arrival curve); :func:`fit_jobs` fits one
from records, :data:`PHILLY_FIT`/:data:`PAI_FIT` are the published
statistics the proxies generate from, :func:`domain_fit` is the fit
behind a config's trace source, and :func:`gen_domain_window` realizes
one seeded window from a fit under a domain draw's arrival knobs.
The same fit and seed give the JAX package's arrays bit for bit
(``tests/test_torch_fit.py``). The serving chaos soak paces its
arrivals with it (:func:`..serve.bench.fit_paced_gaps`); the domain
engine that also calls it waits for its slice.

Fits are statistics, not copies: a window at ``load=1.0,
duration_scale=1.0`` is distribution-matched to its source, not
bit-equal to it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import zlib
from typing import Sequence

import numpy as np

from .records import ArrayTrace, JobRecord, to_array_trace
from .philly_proxy import (N_VIRTUAL_CLUSTERS, PAI_GPU_PROBS, PAI_GPU_SIZES,
                           PAI_MEDIAN_DURATION_S, PAI_DURATION_SIGMA,
                           PAI_N_TENANTS, PHILLY_GPU_PROBS, PHILLY_GPU_SIZES,
                           PHILLY_HOURLY, PHILLY_MEDIAN_DURATION_S,
                           PHILLY_DURATION_SIGMA, _diurnal_arrivals)
from .synthetic import DEFAULT_GPU_PROBS, DEFAULT_GPU_SIZES


@dataclasses.dataclass(frozen=True)
class TraceFit:
    """A workload's marginals, sufficient to regenerate its shape class:
    log-normal duration body (``median_duration_s`` + ``sigma``), gang-
    size histogram, tenant count. Frozen + hashable so it can ride
    config-keyed caches."""
    name: str
    median_duration_s: float
    sigma: float
    gpu_sizes: tuple[int, ...]
    gpu_probs: tuple[float, ...]
    n_tenants: int = 1
    # hour-of-day arrival-rate multipliers (24 bins, mean ~1.0) fitted
    # from the trace's own submit times; () = fall back to the
    # published-statistics PHILLY_HOURLY curve when diurnal shaping is
    # requested
    hourly: tuple[float, ...] = ()

    def __post_init__(self):
        if not (math.isfinite(self.median_duration_s)
                and self.median_duration_s > 0):
            raise ValueError(f"fit {self.name!r}: median_duration_s must "
                             f"be finite and > 0")
        if not (math.isfinite(self.sigma) and self.sigma >= 0):
            raise ValueError(f"fit {self.name!r}: sigma must be finite "
                             f"and >= 0")
        if len(self.gpu_sizes) != len(self.gpu_probs) or not self.gpu_sizes:
            raise ValueError(f"fit {self.name!r}: gpu_sizes/gpu_probs "
                             f"must be non-empty and matched")
        if any(s <= 0 for s in self.gpu_sizes):
            raise ValueError(f"fit {self.name!r}: gang sizes must be > 0")
        if any(p < 0 for p in self.gpu_probs) or sum(self.gpu_probs) <= 0:
            raise ValueError(f"fit {self.name!r}: gpu_probs must be "
                             f"non-negative with positive mass")
        if self.n_tenants <= 0:
            raise ValueError(f"fit {self.name!r}: n_tenants must be > 0")
        if self.hourly:
            if len(self.hourly) != 24:
                raise ValueError(f"fit {self.name!r}: hourly curve must "
                                 f"have 24 bins, got {len(self.hourly)}")
            if any(not math.isfinite(h) or h < 0 for h in self.hourly) \
                    or max(self.hourly) <= 0:
                raise ValueError(f"fit {self.name!r}: hourly curve must "
                                 f"be finite, non-negative, with a "
                                 f"positive peak")

    @property
    def mean_gpus(self) -> float:
        p = np.asarray(self.gpu_probs, np.float64)
        return float(np.dot(self.gpu_sizes, p / p.sum()))

    def mean_duration(self, duration_scale: float = 1.0) -> float:
        """Analytic log-normal mean at a scaled median."""
        return (self.median_duration_s * duration_scale
                * math.exp(0.5 * self.sigma ** 2))


def fit_hourly_curve(submit_s: "np.ndarray | Sequence[float]",
                     floor: float = 0.1) -> tuple[float, ...]:
    """Fit the piecewise hour-of-day arrival curve from submit
    timestamps (seconds; any epoch — only ``t mod 86400`` matters):
    per-hour arrival RATES (count / seconds of that hour-of-day inside
    the trace's span — exposure-normalized, so a span that is not a
    whole number of days does not double-weight the hours its partial
    day covers) normalized to mean 1.0. Deterministic — a histogram, no
    sampling. ``floor`` clamps the relative rate of empty/uncovered
    bins so a short trace still yields a curve the thinning sampler can
    run (a zero bin would make those hours unreachable forever)."""
    t = np.asarray(submit_s, np.float64)
    if t.size == 0:
        raise ValueError("cannot fit an hourly curve from zero arrivals")
    if not np.all(np.isfinite(t)):
        raise ValueError("submit times must be finite")
    day, hour = 86400.0, 3600.0
    hours = ((t % day) // hour).astype(np.int64)
    counts = np.bincount(hours, minlength=24).astype(np.float64)
    # per-bin exposure: seconds of [t0, t1] whose hour-of-day is h
    t0, t1 = float(t.min()), float(t.max())
    exposure = np.zeros(24, np.float64)
    for k in range(int(t0 // day), int(t1 // day) + 1):
        for h in range(24):
            lo, hi = k * day + h * hour, k * day + (h + 1) * hour
            exposure[h] += max(0.0, min(hi, t1) - max(lo, t0))
    covered = exposure > 0
    rate = np.zeros(24, np.float64)
    rate[covered] = counts[covered] / exposure[covered]
    mean_rate = rate[covered].mean() if covered.any() else 1.0
    if mean_rate <= 0:
        raise ValueError("cannot fit an hourly curve: zero arrival rate")
    curve = np.full(24, float(floor))
    curve[covered] = np.maximum(rate[covered] / mean_rate, float(floor))
    curve = curve * (24.0 / curve.sum())   # re-center mean at 1.0
    return tuple(float(h) for h in curve)


def fit_jobs(jobs: Sequence[JobRecord], name: str = "fit") -> TraceFit:
    """Fit a :class:`TraceFit` from records (real CSV loads or generated
    proxies): duration median + log-std, empirical gang histogram,
    observed tenant count, hour-of-day arrival curve."""
    if not jobs:
        raise ValueError("cannot fit an empty job list")
    dur = np.asarray([j.duration for j in jobs], np.float64)
    gpus = np.asarray([j.gpus for j in jobs], np.int64)
    sizes, counts = np.unique(gpus, return_counts=True)
    return TraceFit(
        name=name,
        median_duration_s=float(np.median(dur)),
        sigma=float(np.std(np.log(dur))),
        gpu_sizes=tuple(int(s) for s in sizes),
        gpu_probs=tuple(float(c) / len(jobs) for c in counts),
        n_tenants=int(max(j.tenant for j in jobs)) + 1,
        hourly=fit_hourly_curve([j.submit for j in jobs]))


# Published-statistics presets — identical constants to the proxy
# generators, so the no-CSV configs get an honest fit with no sampling.
PHILLY_FIT = TraceFit("philly", PHILLY_MEDIAN_DURATION_S,
                      PHILLY_DURATION_SIGMA, PHILLY_GPU_SIZES,
                      PHILLY_GPU_PROBS, N_VIRTUAL_CLUSTERS,
                      hourly=PHILLY_HOURLY)
PAI_FIT = TraceFit("pai", PAI_MEDIAN_DURATION_S, PAI_DURATION_SIGMA,
                   PAI_GPU_SIZES, PAI_GPU_PROBS, PAI_N_TENANTS)

_SYNTH_SIGMA = 1.0   # synthetic.gen_poisson_jobs' default log-sigma


@functools.lru_cache(maxsize=None)
def domain_fit(cfg) -> TraceFit:
    """The :class:`TraceFit` behind an ``ExperimentConfig``'s trace
    source: the synthetic generator's own parameters, the Philly/PAI
    published-statistics presets, or a fit of the actual CSV. Cached on
    the (frozen, hashable) config."""
    if cfg.trace == "synthetic":
        # gen_poisson_jobs draws lognormal(mu = ln(mean) - sigma^2/2), so
        # the body's median is mean * exp(-sigma^2/2)
        return TraceFit(
            "synthetic",
            cfg.mean_duration * math.exp(-0.5 * _SYNTH_SIGMA ** 2),
            _SYNTH_SIGMA, DEFAULT_GPU_SIZES, DEFAULT_GPU_PROBS,
            max(cfg.n_tenants, 1))
    if cfg.trace == "philly-proxy":
        return PHILLY_FIT
    if cfg.trace == "pai-proxy":
        return PAI_FIT
    if cfg.trace_path is None:
        raise ValueError(f"config {cfg.name!r} uses trace={cfg.trace!r} "
                         f"with no trace_path; cannot fit a job mix")
    if cfg.trace == "philly":
        from .philly import load_philly_jobs
        return fit_jobs(load_philly_jobs(cfg.trace_path), "philly-csv")
    if cfg.trace == "pai":
        from .pai import load_pai_jobs
        return fit_jobs(load_pai_jobs(cfg.trace_path), "pai-csv")
    raise ValueError(f"no fit recipe for trace={cfg.trace!r}")


def gen_domain_window(fit: TraceFit, n_jobs: int, seed, n_gpus: int,
                      load: float, duration_scale: float = 1.0,
                      burst_frac: float = 0.0, diurnal: bool = False,
                      max_gang: int | None = None,
                      n_tenants: int | None = None) -> ArrayTrace:
    """One seeded episode window from ``fit`` under a domain draw's
    arrival knobs, offered at ``load``x the capacity of THIS draw's
    ``n_gpus`` cluster (so a half-capacity geometry draw at load 1.1 is
    genuinely 1.1x oversubscribed, not accidentally 0.55x).

    ``seed`` may be an int or a tuple of ints (e.g. ``(base_seed, env,
    window_cursor)``) — the window-streaming path re-derives later
    windows by bumping the cursor component. ``max_gang`` renormalizes
    the gang mix to sizes the cluster can actually place (the proxy-
    generator recipe); a flash crowd collapses ``burst_frac`` of the
    jobs onto one burst instant."""
    if n_jobs <= 0:
        raise ValueError("n_jobs must be positive")
    if n_gpus <= 0:
        raise ValueError("n_gpus must be positive")
    if not (math.isfinite(load) and load > 0):
        raise ValueError(f"load must be finite and > 0, got {load}")
    if not (math.isfinite(duration_scale) and duration_scale > 0):
        raise ValueError(f"duration_scale must be finite and > 0, got "
                         f"{duration_scale}")
    if not 0.0 <= burst_frac <= 1.0:
        raise ValueError(f"burst_frac must be in [0, 1], got {burst_frac}")
    entropy = list(seed) if isinstance(seed, (tuple, list)) else [int(seed)]
    rng = np.random.default_rng(
        [zlib.crc32(("fit:" + fit.name).encode()),
         *[int(s) & 0xFFFFFFFF for s in entropy]])

    sizes = np.asarray(fit.gpu_sizes, np.int64)
    probs = np.asarray(fit.gpu_probs, np.float64)
    if max_gang is not None:
        keep = sizes <= max_gang
        if not keep.any():
            # a heavily shrunken geometry draw can under-run every fitted
            # gang size; single-GPU jobs are always placeable (capacity
            # sum >= 1 by the domain sampler's guard)
            sizes, probs = np.asarray([1]), np.asarray([1.0])
        else:
            sizes, probs = sizes[keep], probs[keep]
    probs = probs / probs.sum()
    mean_gpus = float(np.dot(sizes, probs))

    # rate = load * n_gpus / E[gpus * duration] (independent draws)
    rate = load * n_gpus / (mean_gpus * fit.mean_duration(duration_scale))
    if diurnal:
        submit = _diurnal_arrivals(rate, n_jobs, rng,
                                   hourly=(fit.hourly or PHILLY_HOURLY))
    else:
        submit = np.cumsum(rng.exponential(1.0 / rate, size=n_jobs))
    n_burst = int(round(burst_frac * n_jobs))
    if n_burst:
        # the crowd arrives mid-window on top of the background process
        burst_at = float(rng.uniform(0.2, 0.6) * submit[-1])
        submit[rng.choice(n_jobs, size=n_burst, replace=False)] = burst_at
    submit -= submit.min()       # first arrival at t=0, like gen_poisson_jobs

    mu = math.log(fit.median_duration_s * duration_scale)
    duration = np.maximum(1.0, rng.lognormal(mu, fit.sigma, size=n_jobs))
    gpus = rng.choice(sizes, size=n_jobs, p=probs)
    tenants = max(n_tenants if n_tenants is not None else fit.n_tenants, 1)
    tenant = rng.integers(0, tenants, size=n_jobs)
    jobs = [JobRecord(i, float(submit[i]), float(duration[i]),
                      int(gpus[i]), int(tenant[i]))
            for i in range(n_jobs)]
    return to_array_trace(jobs, max_jobs=n_jobs)
