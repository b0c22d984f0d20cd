"""Seeded synthetic Poisson job-trace generator (L0), config 1's source.

A numpy copy of the JAX package's ``traces/synthetic.py``: Poisson
arrivals, log-normal service times, power-of-two gang sizes. The draw
order is the original's, so a seed gives byte-equal arrays."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .records import ArrayTrace, JobRecord, to_array_trace

DEFAULT_GPU_SIZES = (1, 2, 4, 8)
DEFAULT_GPU_PROBS = (0.55, 0.2, 0.15, 0.1)


def gen_poisson_jobs(
    rate: float,
    n_jobs: int,
    seed: int,
    mean_duration: float = 600.0,
    sigma: float = 1.0,
    gpu_sizes: Sequence[int] = DEFAULT_GPU_SIZES,
    gpu_probs: Sequence[float] = DEFAULT_GPU_PROBS,
    n_tenants: int = 1,
) -> list[JobRecord]:
    """Poisson arrivals at ``rate`` jobs/s; log-normal durations with the
    given mean; gang sizes drawn from ``gpu_sizes``. Determined by
    ``seed``."""
    if rate <= 0 or n_jobs <= 0:
        raise ValueError("rate and n_jobs must be positive")
    rng = np.random.default_rng(seed)
    inter = rng.exponential(1.0 / rate, size=n_jobs)
    submit = np.cumsum(inter)
    submit[0] = 0.0  # first job arrives at t=0 so episodes start at once
    # log-normal with mean = mean_duration: mu = ln(mean) - sigma^2/2
    mu = np.log(mean_duration) - 0.5 * sigma**2
    duration = np.maximum(1.0, rng.lognormal(mu, sigma, size=n_jobs))
    gpus = rng.choice(np.asarray(gpu_sizes, np.int32), size=n_jobs,
                      p=np.asarray(gpu_probs) / np.sum(gpu_probs))
    tenant = rng.integers(0, n_tenants, size=n_jobs)
    return [JobRecord(i, float(submit[i]), float(duration[i]), int(gpus[i]),
                      int(tenant[i])) for i in range(n_jobs)]


def gen_poisson_trace(rate: float, n_jobs: int, seed: int,
                      max_jobs: int | None = None, **kw) -> ArrayTrace:
    return to_array_trace(gen_poisson_jobs(rate, n_jobs, seed, **kw),
                          max_jobs=max_jobs)
