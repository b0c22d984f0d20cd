"""Per-rank heartbeat files and their staleness monitor, of the port.

Counterpart of the JAX package's ``resilience/heartbeat.py``, the same
file format (``rank<r>.hb`` holding ``"<step> <monotonic time>"``), so
either package's supervisor reads either package's ranks. Plain Python:
nothing here touches torch.

A dead rank leaves its peers blocked inside a collective, and no
exception ever reaches the survivors, so liveness is observed from
outside the gang: each rank atomically rewrites its file before every
train step, and the supervisor (:class:`.supervisor.Supervisor`)
declares a rank dead when its file goes stale past the timeout (or its
process exits non-zero, the fast path).

Beats carry ``time.monotonic()`` stamps, not wall time: a wall clock
that steps backwards would make a dead rank look alive, one that steps
forwards a live rank stale. CLOCK_MONOTONIC is shared by every process
on one host, the topology of a gang launched on one machine; across
hosts the reader would have to stamp beats itself.

Writes cannot be torn: the beat goes to a writer-private temporary file
(suffixed with the pid, so a predecessor not yet reaped cannot
interleave with its replacement) and lands with ``os.replace``, so a
reader sees the old beat or the new one, never half a line.
"""
from __future__ import annotations

import os
import time
from typing import Callable


class HeartbeatWriter:
    """One rank's side: ``beat(step)`` atomically rewrites the rank's
    file with the step and a monotonic stamp. ``clock`` is injectable
    for tests; the default (``time.monotonic``) must match the
    monitor's."""

    def __init__(self, directory: str, rank: int,
                 clock: Callable[[], float] = time.monotonic):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"rank{rank}.hb")
        # a pid-unique temporary: after a gang restart the old rank's
        # process may not be reaped yet, and a shared name would let its
        # last write race the new rank's
        self._tmp = f"{self.path}.tmp.{os.getpid()}"
        self._clock = clock

    def beat(self, step: int) -> None:
        with open(self._tmp, "w") as f:
            f.write(f"{step} {self._clock()}")
        os.replace(self._tmp, self.path)   # atomic on POSIX


class HeartbeatMonitor:
    """The supervisor's side: which ranks have not beaten within
    ``timeout_s``? The threshold is the caller's: it must cover the
    deployment's longest legitimate stretch without a beat, which no
    constant can know. A rank with no file yet is judged against the
    monitor's start time (the grace of a slow start)."""

    def __init__(self, directory: str, n_ranks: int, timeout_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.directory = directory
        self.n_ranks = n_ranks
        self.timeout_s = timeout_s
        self._clock = clock
        self._t0 = clock()

    def restart(self) -> None:
        """Re-arm the grace window of missing files (call when the gang
        is (re)spawned)."""
        self._t0 = self._clock()

    def read(self) -> dict[int, tuple[int, float]]:
        """``{rank: (last step, monotonic time of the beat)}`` for the
        ranks that have beaten."""
        out = {}
        for r in range(self.n_ranks):
            path = os.path.join(self.directory, f"rank{r}.hb")
            try:
                with open(path) as f:
                    step_s, ts_s = f.read().split()
                out[r] = (int(step_s), float(ts_s))
            except (FileNotFoundError, ValueError):
                continue   # not written yet, or unreadable
        return out

    def stale_ranks(self, now: float | None = None) -> list[int]:
        now = self._clock() if now is None else now
        beats = self.read()
        stale = []
        for r in range(self.n_ranks):
            last = beats.get(r, (None, self._t0))[1]
            if now - last > self.timeout_s:
                stale.append(r)
        return stale
