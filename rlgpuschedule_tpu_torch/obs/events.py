"""Structured event bus: append-only JSONL streams, one per rank.

The port's copy of the JAX package's ``obs/events.py`` (pure Python).

The unit of telemetry is an *event*: one JSON object per line, stamped
with everything needed to reconstruct a multi-process run after the
fact — schema version, emitting rank + pid, a per-process sequence
number, and BOTH clocks:

- ``mono`` (``time.monotonic()``) orders events. CLOCK_MONOTONIC is
  shared by every process on one host, which is exactly the supervised
  dryrun's topology (supervisor + ranks on one machine) — the same
  clock-discipline argument as ``resilience.heartbeat``. Wall clocks
  jump (NTP slew/step); an event log ordered by wall time can show a
  restart *before* the failure that caused it.
- ``wall`` (``time.time()``) is carried as a human-readable timestamp
  field only, never as an ordering key.

Writers append + flush one line per event, so the only torn state a
crash can leave is a truncated LAST line — which :func:`read_events`
tolerates by skipping undecodable lines instead of failing the whole
post-mortem (the log exists precisely for runs that died mid-write).
Opt-in ``durable=True`` additionally fsyncs each emit so the line also
survives power loss/kernel death; it stays off by default because an
fsync per event is a disk round trip where a flush is ~microseconds,
and the process-crash case the bus is built for does not need it.

A relaunched rank (same rank id, new pid, new attempt) appends to the
same per-rank file: one stream per rank across the run's whole
supervised lifetime, with ``pid``/``seq`` telling attempts apart.
"""
from __future__ import annotations

import glob
import json
import os
import threading
import time
from typing import IO, Any, Callable, Iterable

SCHEMA_VERSION = 1

# stamp fields the bus owns; emit() refuses payload keys that would
# silently shadow them
RESERVED_FIELDS = ("v", "kind", "rank", "pid", "seq", "mono", "wall")


def stream_path(directory: str, name: str) -> str:
    return os.path.join(directory, f"events.{name}.jsonl")


class EventBus:
    """One process's writer end of the event stream.

    >>> bus = EventBus(obs_dir, rank=0)
    >>> bus.emit("run_start", config="ppo-mlp-synth64", iterations=100)
    >>> bus.close()

    ``name`` sets the stream file (``events.<name>.jsonl``); it defaults
    to ``rank<r>`` so per-rank streams sort naturally. Non-rank emitters
    (the supervisor) pass ``rank=-1`` and a readable name. ``clock`` /
    ``wall`` are injectable for deterministic ordering tests.
    """

    def __init__(self, directory: str, rank: int = 0,
                 name: str | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time,
                 durable: bool = False):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.rank = int(rank)
        self.name = name if name is not None else f"rank{self.rank}"
        self.path = stream_path(directory, self.name)
        self._clock = clock
        self._wall = wall
        self._seq = 0
        # durable=True fsyncs every emit: the line survives power loss,
        # not just process death. Default stays flush-only — a flush
        # reaches the OS page cache (enough for the crash post-mortems
        # this bus exists for, where the kernel outlives the process)
        # at ~microseconds per event, while fsync costs a disk round
        # trip per event and belongs only on streams that feed durable
        # ledgers (the flywheel's promotion lineage, kill-mid-write
        # tests)
        self.durable = bool(durable)
        # the async engine's actor thread and the learner (caller)
        # thread share one rank's bus: serialize the stamp+write so seq
        # stays gapless and lines never interleave mid-record
        self._emit_lock = threading.Lock()
        self._file: IO[str] | None = open(self.path, "a")

    def emit(self, kind: str, **fields: Any) -> dict:
        """Append one event; returns the full stamped record. Payload
        values must be JSON-serializable (the writer fails loudly at the
        emit site rather than leaving a poisoned line)."""
        if self._file is None:
            raise ValueError(f"event bus {self.path} is closed")
        bad = [k for k in fields if k in RESERVED_FIELDS]
        if bad:
            raise ValueError(f"event field(s) {bad} shadow the bus's own "
                             f"stamp fields {RESERVED_FIELDS}")
        with self._emit_lock:
            event = {"v": SCHEMA_VERSION, "kind": kind, "rank": self.rank,
                     "pid": os.getpid(), "seq": self._seq,
                     "mono": self._clock(), "wall": self._wall(), **fields}
            self._seq += 1
            self._file.write(json.dumps(event, sort_keys=True) + "\n")
            self._file.flush()
            if self.durable:
                os.fsync(self._file.fileno())
        return event

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "EventBus":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path: str) -> list[dict]:
    """Read one stream, tolerating a torn/truncated last line (the one
    state a crashed writer can leave — each event is a single buffered
    write + flush). Undecodable or non-object lines are skipped, not
    fatal: the reader exists for post-mortems of runs that died
    mid-write."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(event, dict):
                out.append(event)
    return out


def event_streams(directory: str) -> list[str]:
    """Every stream file under ``directory``, sorted for determinism."""
    return sorted(glob.glob(stream_path(directory, "*")))


def merge_events(events: Iterable[dict]) -> list[dict]:
    """Order interleaved per-rank events into ONE timeline: primary key
    is the shared monotonic clock; ``(rank, seq)`` breaks exact ties
    deterministically (seq alone also fixes the order of same-process
    events, whose mono stamps are already strictly increasing)."""
    return sorted(events,
                  key=lambda e: (e.get("mono", e.get("wall", 0.0)),
                                 e.get("rank", 0), e.get("seq", 0)))


def merge_dir(directory: str) -> list[dict]:
    """Merge every per-rank stream under ``directory`` into one ordered
    timeline. Raises FileNotFoundError when the directory holds no
    streams at all (an empty post-mortem should fail loudly)."""
    paths = event_streams(directory)
    if not paths:
        raise FileNotFoundError(
            f"no event streams (events.*.jsonl) under {directory}")
    merged: list[dict] = []
    for p in paths:
        merged.extend(read_events(p))
    return merge_events(merged)
