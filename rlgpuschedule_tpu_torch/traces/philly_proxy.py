"""Philly-statistics proxy trace generator (L0), config 2's source.

A numpy copy of the JAX package's ``traces/philly_proxy.py``, with its
PAI preset (:func:`gen_pai_proxy_trace`). It draws a seeded trace with the workload statistics
published with the Microsoft Philly trace (Jeon et al., USENIX ATC'19):
power-of-two gangs dominated by 1-GPU jobs with a thin 128-GPU tail;
heavy-tailed log-normal durations; a pass/killed/failed status mix with
status-dependent durations; diurnal Poisson arrivals; 14 Zipf-skewed
virtual clusters. The arrival rate is set by an offered load against an
``n_gpus`` cluster. The draw order is the original's, so a seed gives
byte-equal arrays.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from .records import (STATUS_FAILED, STATUS_KILLED, STATUS_PASS, ArrayTrace,
                      JobRecord, to_array_trace)

PHILLY_GPU_SIZES = (1, 2, 4, 8, 16, 32, 64, 128)
PHILLY_GPU_PROBS = (0.70, 0.09, 0.08, 0.08, 0.03, 0.013, 0.005, 0.002)

PHILLY_STATUS = (STATUS_PASS, STATUS_KILLED, STATUS_FAILED)
PHILLY_STATUS_PROBS = (0.66, 0.22, 0.12)
# failed jobs fail early; killed jobs are the long-runners users give up on
_STATUS_DUR_MULT = {STATUS_PASS: 1.0, STATUS_KILLED: 2.0, STATUS_FAILED: 0.25}

PHILLY_MEDIAN_DURATION_S = 720.0
PHILLY_DURATION_SIGMA = 1.9
MIN_DURATION_S = 30.0
MAX_DURATION_S = 30 * 86400.0

N_VIRTUAL_CLUSTERS = 14
_DAY_S = 86400.0
_HOUR_S = 3600.0

# Hour-of-day arrival-rate multipliers (mean 1.0): overnight trough,
# morning ramp, working-hour plateau, evening tail-off.
PHILLY_HOURLY: tuple[float, ...] = (
    0.72, 0.62, 0.55, 0.51, 0.48, 0.50,
    0.58, 0.74, 0.95, 1.18, 1.35, 1.42,
    1.30, 1.38, 1.48, 1.50, 1.45, 1.38,
    1.25, 1.12, 0.97, 0.90, 0.88, 0.79,
)


def _diurnal_arrivals(rate: float, n_jobs: int, rng: np.random.Generator,
                      hourly: Sequence[float] = PHILLY_HOURLY) -> np.ndarray:
    """Non-homogeneous Poisson arrivals at mean rate ``rate`` modulated by
    the hour-of-day curve, by thinning candidates drawn at the peak
    rate."""
    curve = np.asarray(hourly, np.float64)
    peak_mult = float(curve.max())
    peak = rate * peak_mult
    out = np.empty(0, np.float64)
    t = 0.0
    while out.size < n_jobs:
        need = n_jobs - out.size
        n_cand = int(need * peak_mult * 1.2) + 16
        cand = t + np.cumsum(rng.exponential(1.0 / peak, size=n_cand))
        t = float(cand[-1])
        hour = ((cand % _DAY_S) // _HOUR_S).astype(np.int64)
        accept = curve[hour] / peak_mult
        out = np.concatenate([out, cand[rng.random(n_cand) < accept]])
    return out[:n_jobs]


def base_arrival_rate(n_gpus: int, load: float,
                      gpu_sizes: Sequence[int] = PHILLY_GPU_SIZES,
                      gpu_probs: Sequence[float] = PHILLY_GPU_PROBS,
                      median_duration: float = PHILLY_MEDIAN_DURATION_S,
                      sigma: float = PHILLY_DURATION_SIGMA) -> float:
    """Jobs/s such that the offered load (requested GPU-seconds per
    second over ``n_gpus``) equals ``load``."""
    body_mean = math.exp(math.log(median_duration) + 0.5 * sigma ** 2)
    mean_dur = body_mean * sum(p * _STATUS_DUR_MULT[s] for s, p in
                               zip(PHILLY_STATUS, PHILLY_STATUS_PROBS))
    probs = np.asarray(gpu_probs) / np.sum(gpu_probs)
    return load * n_gpus / (float(np.dot(gpu_sizes, probs)) * mean_dur)


def gen_philly_proxy_jobs(
    n_jobs: int,
    seed: int,
    n_gpus: int = 512,
    load: float = 1.1,
    max_gang: int | None = None,
    n_tenants: int = N_VIRTUAL_CLUSTERS,
    gpu_sizes: Sequence[int] = PHILLY_GPU_SIZES,
    gpu_probs: Sequence[float] = PHILLY_GPU_PROBS,
    median_duration: float = PHILLY_MEDIAN_DURATION_S,
    sigma: float = PHILLY_DURATION_SIGMA,
) -> list[JobRecord]:
    """``n_jobs`` seeded jobs with Philly-statistics marginals, offered at
    ``load`` times the capacity of an ``n_gpus`` cluster. ``max_gang``
    drops gang sizes above the cluster's reach and renormalizes the mix."""
    if n_jobs <= 0:
        raise ValueError("n_jobs must be positive")
    rng = np.random.default_rng(seed)

    sizes = np.asarray(gpu_sizes, np.int64)
    probs = np.asarray(gpu_probs, np.float64)
    if max_gang is not None:
        keep = sizes <= max_gang
        if not keep.any():
            raise ValueError(f"max_gang={max_gang} below smallest gang size")
        sizes, probs = sizes[keep], probs[keep]
    probs = probs / probs.sum()

    rate = base_arrival_rate(n_gpus, load, sizes, probs, median_duration,
                             sigma)
    submit = _diurnal_arrivals(rate, n_jobs, rng)
    submit -= submit[0]          # first job at t=0

    gpus = rng.choice(sizes, size=n_jobs, p=probs)
    status = rng.choice(np.asarray(PHILLY_STATUS, np.int64), size=n_jobs,
                        p=np.asarray(PHILLY_STATUS_PROBS))
    mult = np.asarray([_STATUS_DUR_MULT[s] for s in PHILLY_STATUS])[status]
    dur = rng.lognormal(math.log(median_duration), sigma, size=n_jobs) * mult
    dur = np.clip(dur, MIN_DURATION_S, MAX_DURATION_S)

    ranks = np.arange(1, n_tenants + 1, dtype=np.float64)
    tenant_probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    tenant = rng.choice(n_tenants, size=n_jobs, p=tenant_probs)

    return [JobRecord(i, float(submit[i]), float(dur[i]), int(gpus[i]),
                      int(tenant[i]), int(status[i]))
            for i in range(n_jobs)]


def gen_philly_proxy_trace(n_jobs: int, seed: int,
                           max_jobs: int | None = None,
                           **kw) -> ArrayTrace:
    return to_array_trace(gen_philly_proxy_jobs(n_jobs, seed, **kw),
                          max_jobs=max_jobs)


# The PAI-statistics preset (Weng et al., "MLaaS in the Wild", NSDI'22):
# smaller gangs than Philly's (1-GPU jobs dominate harder, gangs rarely
# exceed 8), minutes-scale durations, many tenants sharing one cluster.
PAI_GPU_SIZES = (1, 2, 4, 8)
PAI_GPU_PROBS = (0.81, 0.10, 0.06, 0.03)
PAI_MEDIAN_DURATION_S = 300.0
PAI_DURATION_SIGMA = 1.6
PAI_N_TENANTS = 24


def gen_pai_proxy_jobs(n_jobs: int, seed: int, n_gpus: int = 128,
                       load: float = 1.1, max_gang: int | None = None,
                       n_tenants: int = PAI_N_TENANTS) -> list[JobRecord]:
    return gen_philly_proxy_jobs(
        n_jobs, seed, n_gpus=n_gpus, load=load, max_gang=max_gang,
        n_tenants=n_tenants, gpu_sizes=PAI_GPU_SIZES,
        gpu_probs=PAI_GPU_PROBS, median_duration=PAI_MEDIAN_DURATION_S,
        sigma=PAI_DURATION_SIGMA)


def gen_pai_proxy_trace(n_jobs: int, seed: int, max_jobs: int | None = None,
                        **kw) -> ArrayTrace:
    return to_array_trace(gen_pai_proxy_jobs(n_jobs, seed, **kw),
                          max_jobs=max_jobs)
