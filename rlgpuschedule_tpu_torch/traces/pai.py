"""Alibaba PAI cluster-trace loader (L0).

A copy of the JAX package's ``traces/pai.py``. It reads the CSV shape of
the public Alibaba cluster-trace-gpu releases (one row per job or
instance; ``plan_gpu`` a percentage, 100 = one GPU), rounds fractional
GPU requests up to whole gang sizes (the simulator allocates whole
GPUs), and maps users to dense tenant ids.

Expected columns (aliases): job_name (job_id, inst_id), submit_time
(create_time), start_time, end_time, plan_gpu (gpu_request, num_gpus),
user (user_name, group).
"""
from __future__ import annotations

import csv
import math
from pathlib import Path

from .records import ArrayTrace, JobRecord, parse_status, to_array_trace

_ALIASES = {
    "job_id": ("job_name", "job_id", "inst_id", "instance"),
    "submit": ("submit_time", "create_time", "submit"),
    "start": ("start_time", "start"),
    "end": ("end_time", "end"),
    "gpus": ("plan_gpu", "gpu_request", "num_gpus", "gpus"),
    "status": ("status", "state"),
    "tenant": ("user", "user_name", "group", "tenant"),
}


def _col(header, key):
    lower = {h.lower().strip(): h for h in header}
    for alias in _ALIASES[key]:
        if alias in lower:
            return lower[alias]
    return None


def load_pai_jobs(path: str | Path, max_jobs: int | None = None,
                  gpu_is_percent: bool | None = None) -> list[JobRecord]:
    """Parse a PAI-style CSV. ``gpu_is_percent=None`` auto-detects: if
    the column is named plan_gpu or any value exceeds 8, values are
    percentages of a GPU and are divided by 100 before the ceiling."""
    path = Path(path)
    with path.open(newline="") as f:
        reader = csv.DictReader(f)
        header = reader.fieldnames or []
        cols = {k: _col(header, k) for k in _ALIASES}
        for need in ("submit", "gpus", "start", "end"):
            if cols[need] is None and not (need == "submit"
                                           and cols["start"]):
                raise ValueError(f"{path}: missing column for {need}; "
                                 f"got {header}")
        rows = []
        for row in reader:
            if max_jobs is not None and len(rows) >= max_jobs:
                break
            try:
                start = float(row[cols["start"]])
                end = float(row[cols["end"]])
                submit = float(row[cols["submit"]]) if cols["submit"] \
                    else start
                gpu_raw = float(row[cols["gpus"]])
            except (ValueError, KeyError, TypeError):
                continue
            duration = end - start
            if duration <= 0 or gpu_raw <= 0:
                continue
            status = parse_status(row[cols["status"]]) if cols["status"] \
                else 0
            tkey = row[cols["tenant"]].strip() if cols["tenant"] else "0"
            rows.append((submit, duration, gpu_raw, tkey, status))
    if not rows:
        return []
    if gpu_is_percent is None:
        gpu_is_percent = (cols["gpus"].lower() == "plan_gpu"
                          or any(r[2] > 8 for r in rows))
    t0 = min(r[0] for r in rows)
    rows.sort(key=lambda r: r[0])
    tenants: dict[str, int] = {}
    jobs = []
    for i, (s, d, g, tkey, st) in enumerate(rows):
        gpus = max(1, math.ceil(g / 100.0 if gpu_is_percent else g))
        jobs.append(JobRecord(i, s - t0, d, gpus,
                              tenants.setdefault(tkey, len(tenants)), st))
    return jobs


def load_pai(path: str | Path, max_jobs: int | None = None) -> ArrayTrace:
    return to_array_trace(load_pai_jobs(path, max_jobs=max_jobs),
                          max_jobs=max_jobs)
