"""Microsoft Philly cluster-trace loader (L0).

A copy of the JAX package's ``traces/philly.py``. It reads the flattened
CSV form of the public Philly job logs (one row per job) into
:class:`JobRecord`; column aliases cover the common exports. Failed and
killed jobs are kept: they held their GPUs for their recorded runtime.

Expected columns (aliases in parentheses):
  job_id (jobid), submit_time (submitted_time), duration (run_time) OR
  start_time+end_time, num_gpus (gpus, gpu_num), status, user (vc, tenant).
Timestamps may be epoch seconds or ISO strings; durations are seconds.
"""
from __future__ import annotations

import csv
import datetime as _dt
from pathlib import Path

from .records import ArrayTrace, JobRecord, parse_status, to_array_trace

_ALIASES = {
    "job_id": ("job_id", "jobid", "job"),
    "submit": ("submit_time", "submitted_time", "submit"),
    "start": ("start_time", "start"),
    "end": ("end_time", "finish_time", "end"),
    "duration": ("duration", "run_time", "runtime"),
    "gpus": ("num_gpus", "gpus", "gpu_num", "gpu_count"),
    "status": ("status", "state", "final_status"),
    "tenant": ("user", "vc", "tenant", "virtual_cluster"),
}


def _col(header: list[str], key: str) -> str | None:
    lower = {h.lower().strip(): h for h in header}
    for alias in _ALIASES[key]:
        if alias in lower:
            return lower[alias]
    return None


def _to_seconds(v: str) -> float:
    v = v.strip()
    try:
        return float(v)
    except ValueError:
        return _dt.datetime.fromisoformat(v).timestamp()


def load_philly_jobs(path: str | Path, max_jobs: int | None = None,
                     min_duration: float = 1.0) -> list[JobRecord]:
    """Parse a Philly-style job CSV into records. Rows with no resolvable
    duration or zero GPUs are skipped; submit times are re-based to the
    earliest job; tenants (users or VCs) get dense integer ids."""
    path = Path(path)
    with path.open(newline="") as f:
        reader = csv.DictReader(f)
        header = reader.fieldnames or []
        cols = {k: _col(header, k) for k in _ALIASES}
        if cols["submit"] is None or cols["gpus"] is None:
            raise ValueError(f"{path}: need submit_time and num_gpus "
                             f"columns; got {header}")
        if cols["duration"] is None and (cols["start"] is None
                                         or cols["end"] is None):
            raise ValueError(f"{path}: need duration or start+end columns")
        tenants: dict[str, int] = {}
        raw = []
        for row in reader:
            if max_jobs is not None and len(raw) >= max_jobs:
                break
            try:
                submit = _to_seconds(row[cols["submit"]])
                gpus = int(float(row[cols["gpus"]]))
                if cols["duration"] is not None and \
                        row[cols["duration"]].strip():
                    duration = float(row[cols["duration"]])
                else:
                    duration = (_to_seconds(row[cols["end"]])
                                - _to_seconds(row[cols["start"]]))
            except (ValueError, KeyError, TypeError):
                continue
            if gpus <= 0 or duration < min_duration:
                continue
            status = parse_status(row[cols["status"]]) if cols["status"] \
                else 0
            tkey = row[cols["tenant"]].strip() if cols["tenant"] else "0"
            tenant = tenants.setdefault(tkey, len(tenants))
            raw.append((submit, duration, gpus, tenant, status))
    if not raw:
        return []
    t0 = min(r[0] for r in raw)
    raw.sort(key=lambda r: r[0])
    return [JobRecord(i, s - t0, d, g, t, st)
            for i, (s, d, g, t, st) in enumerate(raw)]


def load_philly(path: str | Path, max_jobs: int | None = None) -> ArrayTrace:
    jobs = load_philly_jobs(path, max_jobs=max_jobs)
    return to_array_trace(jobs, max_jobs=max_jobs)
