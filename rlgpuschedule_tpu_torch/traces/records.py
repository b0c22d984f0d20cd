"""Job records and fixed-shape array traces (L0).

A numpy copy of the JAX package's ``traces/records.py``: the port must
not import that package, so what it needs is repeated here. Same seed,
same records, same arrays, byte for byte (``tests/test_torch_traces.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# Terminal status of a job in the source trace. Failed and killed jobs
# still hold their GPUs for their recorded duration.
STATUS_PASS = 0
STATUS_KILLED = 1
STATUS_FAILED = 2

_STATUS_NAMES = {"pass": STATUS_PASS, "passed": STATUS_PASS,
                 "completed": STATUS_PASS, "terminated": STATUS_PASS,
                 "killed": STATUS_KILLED, "canceled": STATUS_KILLED,
                 "cancelled": STATUS_KILLED,
                 "failed": STATUS_FAILED, "error": STATUS_FAILED}


def parse_status(s: str | int) -> int:
    """A terminal status from a trace's CSV: a code, or a name in any
    case (unknown names read as passed)."""
    if isinstance(s, (int, np.integer)):
        return int(s)
    return _STATUS_NAMES.get(s.strip().lower(), STATUS_PASS)


@dataclasses.dataclass(frozen=True)
class JobRecord:
    """One job of a normalized trace.

    ``duration`` is the service time at full allocation, in seconds;
    ``submit`` is seconds since trace start; ``gpus`` is the gang size
    (all-or-nothing: the job runs only with all of them at once)."""

    job_id: int
    submit: float
    duration: float
    gpus: int
    tenant: int = 0
    status: int = STATUS_PASS

    def __post_init__(self):
        if self.duration <= 0:
            raise ValueError(f"job {self.job_id}: duration must be > 0")
        if self.gpus <= 0:
            raise ValueError(f"job {self.job_id}: gpus must be > 0")
        if self.submit < 0:
            raise ValueError(f"job {self.job_id}: submit must be >= 0")


@dataclasses.dataclass(frozen=True)
class ArrayTrace:
    """A trace as fixed-shape numpy arrays, padded to ``max_jobs``.

    Padding rows have ``valid == False`` and ``submit == +inf`` so they
    never arrive in the simulator. Rows are sorted by submit time."""

    submit: np.ndarray    # [J] float32, +inf on padding
    duration: np.ndarray  # [J] float32, 1.0 on padding (never used)
    gpus: np.ndarray      # [J] int32, 0 on padding
    tenant: np.ndarray    # [J] int32
    valid: np.ndarray     # [J] bool

    @property
    def max_jobs(self) -> int:
        return int(self.submit.shape[0])

    @property
    def num_jobs(self) -> int:
        return int(self.valid.sum())

    def slice(self, start: int, count: int) -> "ArrayTrace":
        """A window of ``count`` jobs starting at the ``start``-th valid
        job, re-based so the first job submits at t=0."""
        idx = np.flatnonzero(self.valid)[start:start + count]
        recs = [JobRecord(int(i), float(self.submit[i]),
                          float(self.duration[i]), int(self.gpus[i]),
                          int(self.tenant[i])) for i in idx]
        t0 = recs[0].submit if recs else 0.0
        recs = [dataclasses.replace(r, job_id=k, submit=r.submit - t0)
                for k, r in enumerate(recs)]
        return to_array_trace(recs, max_jobs=count)


def to_array_trace(jobs: Sequence[JobRecord],
                   max_jobs: int | None = None) -> ArrayTrace:
    """Pack records into a padded, submit-sorted ArrayTrace."""
    jobs = sorted(jobs, key=lambda j: (j.submit, j.job_id))
    n = len(jobs)
    j = max_jobs if max_jobs is not None else n
    if n > j:
        raise ValueError(f"{n} jobs > max_jobs={j}")
    submit = np.full(j, np.inf, np.float32)
    duration = np.ones(j, np.float32)
    gpus = np.zeros(j, np.int32)
    tenant = np.zeros(j, np.int32)
    valid = np.zeros(j, bool)
    for k, job in enumerate(jobs):
        submit[k] = job.submit
        duration[k] = job.duration
        gpus[k] = job.gpus
        tenant[k] = job.tenant
        valid[k] = True
    return ArrayTrace(submit, duration, gpus, tenant, valid)
