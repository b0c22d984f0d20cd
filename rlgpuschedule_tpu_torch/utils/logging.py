"""Metrics logging (L6 aux) of the port: scalar curves to CSV, a
TensorBoard event file, and the env-steps/s meter.

A copy of the JAX package's ``utils/logging.py`` (pure Python, no
JAX): the CSV rows, their append-on-resume mode and the schema-drift
errors, and the hand-encoded TensorBoard ``Event`` records with their
masked-crc32c TFRecord framing are byte for byte the JAX package's,
so either package's files read the same. No ``tensorboard`` package
is imported: the writer encodes the protobuf itself.
"""
from __future__ import annotations

import csv
import os
import sys
import time
from typing import IO, Any, Mapping


class MetricsLogger:
    """Append scalar rows keyed by iteration; writes CSV and optionally
    mirrors a compact line to a stream.

    >>> log = MetricsLogger("out/metrics.csv", echo=True)
    >>> log(10, {"mean_reward": -0.5, "total_loss": 0.1})
    >>> log.close()

    The header is fixed by the first row (stable schema for the whole
    run); any later row whose keys differ from the first row's raises, so
    schema drift is caught at the call site rather than producing ragged
    CSVs.

    ``append=True`` is the supervisor-relaunch / ``--resume`` mode: an
    existing CSV's header is re-read and becomes the pinned schema, new
    rows are APPENDED after the history instead of truncating it (mode
    ``"w"`` silently wiped every pre-restart row — the metrics history a
    relaunch exists to continue), and a resumed run whose row keys drift
    from the original header raises the same schema error as in-run
    drift. An ``append=True`` open of a missing/empty file degrades to
    the fresh-file path.

    ``wall_s`` is a DURATION (seconds since this logger was built) and
    is therefore measured on ``time.monotonic()`` — a wall-clock step
    (NTP) mid-run would otherwise bend every downstream steps/s
    computation; event timestamps (wall time proper) belong to the obs
    event bus, not this column.
    """

    def __init__(self, csv_path: str | None = None, echo: bool = False,
                 stream: IO[str] | None = None, append: bool = False):
        self._csv_path = csv_path
        self._echo = echo
        self._append = append
        self._stream = stream or sys.stderr
        self._writer: csv.DictWriter | None = None
        self._file: IO[str] | None = None
        self._fields: list[str] | None = None
        self._t0 = time.monotonic()

    def _open(self, first_row: Mapping[str, Any]) -> None:
        os.makedirs(os.path.dirname(self._csv_path) or ".", exist_ok=True)
        header: list[str] | None = None
        if self._append and os.path.exists(self._csv_path):
            with open(self._csv_path, newline="") as f:
                header = next(csv.reader(f), None)
        if header:
            if set(first_row) != set(header):
                raise ValueError(
                    f"metrics schema drift across resume: existing CSV "
                    f"header has {sorted(header)}, this run logs "
                    f"{sorted(first_row)}")
            self._file = open(self._csv_path, "a", newline="")
            self._fields = list(header)   # keep the original column order
            self._writer = csv.DictWriter(self._file, self._fields)
        else:
            self._file = open(self._csv_path, "w", newline="")
            self._fields = list(first_row)
            self._writer = csv.DictWriter(self._file, self._fields)
            self._writer.writeheader()

    def __call__(self, iteration: int, metrics: Mapping[str, Any]) -> None:
        row = {"iteration": iteration,
               "wall_s": round(time.monotonic() - self._t0, 3)}
        for k, v in metrics.items():
            row[k] = float(v) if hasattr(v, "__float__") else v
        if self._csv_path is not None:
            if self._writer is None:
                self._open(row)
            elif set(row) != set(self._fields):
                raise ValueError(
                    f"metrics schema drift: first row had "
                    f"{sorted(self._fields)}, this row has {sorted(row)}")
            self._writer.writerow(row)
            self._file.flush()
        if self._echo:
            body = " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                            else f"{k}={v}" for k, v in row.items()
                            if k != "iteration")
            print(f"[iter {iteration}] {body}", file=self._stream)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), table-driven — the checksum TFRecord framing
    requires. Pure Python: the write cadence is one small record per logged
    iteration, so speed is irrelevant and we avoid a tensorflow import."""
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_CRC_TABLE: list[int] | None = None


def _crc32c_table() -> list[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for n in range(256):
            crc = n
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    if n < 0:   # proto int64: 10-byte two's-complement encoding
        n &= 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tb_event(wall_time: float, step: int,
              scalars: Mapping[str, float] | None = None,
              file_version: str | None = None) -> bytes:
    """Hand-encoded ``tensorflow.Event`` proto: wall_time (field 1,
    double), step (field 2, int64), file_version (3, string) or summary
    (5, message of Value{tag=1 string, simple_value=2 float})."""
    import struct
    ev = bytearray()
    ev += b"\x09" + struct.pack("<d", wall_time)
    ev += b"\x10" + _varint(step)
    if file_version is not None:
        fv = file_version.encode()
        ev += b"\x1a" + _varint(len(fv)) + fv
    if scalars:
        summary = bytearray()
        for tag, val in scalars.items():
            t = tag.encode()
            value = (b"\x0a" + _varint(len(t)) + t +
                     b"\x15" + struct.pack("<f", float(val)))
            summary += b"\x0a" + _varint(len(value)) + value
        ev += b"\x2a" + _varint(len(summary)) + bytes(summary)
    return bytes(ev)


class TensorBoardWriter:
    """Scalar curves as a TensorBoard event file.

    Dependency-free by design: encodes the ``Event`` protobuf and TFRecord
    framing (length + masked-crc32c) by hand, ~40 lines instead of a
    tensorflow/tensorboard import on the training host. The bytes are the
    JAX package's writer's, whose files read back with stock TensorBoard.

    >>> with TensorBoardWriter("out/tb") as tb:
    ...     tb(10, {"mean_reward": -0.5})
    """

    def __init__(self, logdir: str):
        import socket
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(logdir, name)
        self._file: IO[bytes] = open(self.path, "wb")
        self._record(_tb_event(time.time(), 0,
                               file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        import struct
        header = struct.pack("<Q", len(payload))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(payload)
        self._file.write(struct.pack("<I", _masked_crc(payload)))
        self._file.flush()

    def __call__(self, step: int, metrics: Mapping[str, Any]) -> None:
        scalars = {k: float(v) for k, v in metrics.items()
                   if hasattr(v, "__float__")}
        if scalars:
            self._record(_tb_event(time.time(), int(step), scalars))

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "TensorBoardWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ThroughputMeter:
    """env-steps/sec tracker for the throughput metric. Call
    ``tick(n_steps)`` once per iteration.

    Durations come from ``time.monotonic()``: a wall-clock step (NTP)
    mid-run would otherwise dent (or inflate) the steps/s. ``clock`` is
    injectable for deterministic tests."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._t0 = clock()
        self._steps = 0

    def tick(self, n_steps: int) -> None:
        self._steps += int(n_steps)

    @property
    def steps_per_sec(self) -> float:
        dt = self._clock() - self._t0
        return self._steps / dt if dt > 0 else 0.0
