"""Tracing and profiling (L6 aux) of the port: the torch profiler, the
NaN sanitizer and the host-side section timer.

Counterpart of the JAX package's ``utils/profiling.py``:

- :func:`trace` -- a ``torch.profiler`` session over a block that writes
  a Chrome trace (Perfetto, ``chrome://tracing``, TensorBoard's profile
  plugin) into a directory: kernel activity on the card (CUPTI) beside
  the host's ops, or the host's ops alone on the CPU. On the card a
  torch without CUPTI support raises instead of recording a CPU-only
  trace that would read as a card trace. :class:`TraceSession` is the
  same session started and stopped by hand (the slow-iteration capture
  of :class:`..obs.telemetry.Alarms`); :func:`device_busy_ms` reads a
  session's kernel intervals back as the card's busy time;
- :func:`debug_checks` -- the ``jax_debug_nans`` switch: the enclosed
  code raises ``FloatingPointError`` at the first operation whose
  floating output holds a NaN, naming the operation. Forward operations
  are checked by a ``TorchDispatchMode`` that tests every output;
  backward ones also by ``torch.autograd.detect_anomaly(check_nan=
  True)``. Infinities are legal, as under ``jax_debug_nans`` (the
  simulator's schedules hold +inf). Each check reads a flag back to the
  host, so on the card every operation synchronizes: this is a debug
  mode, and it cannot run under the sync guard (``--alarms``);
- :class:`SectionTimer` -- cumulative host wall-clock per named section.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import socket
import time
from typing import Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_trace_ids = itertools.count()


def _cuda_activity():
    """The torch profiler's CUDA activity; ``RuntimeError`` when this
    torch cannot record it (no CUPTI)."""
    from torch.profiler import ProfilerActivity
    if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
        raise RuntimeError(
            "profiling on a CUDA device needs the torch profiler's CUDA "
            "activity (CUPTI), which this torch does not support; "
            "refusing to record a CPU-only trace of a card run")
    return ProfilerActivity.CUDA


class TraceSession:
    """One torch profiler session writing a Chrome trace into
    ``log_dir`` when stopped. ``device``: ``cuda`` records the card's
    kernels and copies beside the host's ops and raises ``RuntimeError``
    when this torch cannot (no CUPTI); ``cpu`` records the host's ops."""

    def __init__(self, log_dir: str, device: "torch.device | str" = "cuda"):
        from torch.profiler import ProfilerActivity, profile
        self.device = torch.device(device)
        self.log_dir = log_dir
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(_cuda_activity())
        self._prof = profile(activities=activities)
        self.path: str | None = None

    def start(self) -> "TraceSession":
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof.start()
        return self

    def stop(self) -> str:
        """Stop the session and write its trace; returns the file's
        path (``<host>.<pid>.<n>.pt.trace.json``)."""
        if self.device.type == "cuda":
            # the kernels enqueued in the session end inside it
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        self.path = os.path.join(
            self.log_dir, f"{socket.gethostname()}.{os.getpid()}."
                          f"{next(_trace_ids)}.pt.trace.json")
        self._prof.export_chrome_trace(self.path)
        return self.path


@contextlib.contextmanager
def trace(log_dir: str, device: "torch.device | str" = "cuda"
          ) -> Iterator[TraceSession]:
    """Capture a profiler trace of the enclosed block::

        with profiling.trace("out/trace"):
            exp.run(iterations=5)

    Open the ``*.pt.trace.json`` it writes under ``log_dir`` in
    Perfetto. A trace of a long run is large (one config-1 iteration at
    4 x 128 is about 100 MB on the card): trace a few iterations."""
    session = TraceSession(log_dir, device).start()
    try:
        yield session
    finally:
        session.stop()


def device_busy_ms(fn, n: int, device: "torch.device | str") -> float:
    """Milliseconds per call that a CUDA ``device`` spent running work
    over ``n`` calls of ``fn``: the union of the kernel, copy and memset
    intervals the torch profiler records (CUDA activity only), so the
    gaps where the card waited on the host do not count, unlike an
    event pair's span. Raises where CUPTI is missing."""
    from torch.autograd import DeviceType
    from torch.profiler import profile
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device_busy_ms times a CUDA device, not "
                         f"{device}")
    torch.cuda.synchronize(device)
    with profile(activities=[_cuda_activity()]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize(device)
    return covered_ns((e.start_ns(), e.end_ns())
                      for e in prof.profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CUDA) / 1e6 / n


def covered_ns(spans) -> int:
    """The length of the union of ``(start, end)`` intervals."""
    busy, end = 0, None
    for lo, hi in sorted(spans):
        if end is None or lo >= end:
            busy, end = busy + hi - lo, hi
        elif hi > end:
            busy, end = busy + hi - end, hi
    return busy


class _NanCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` when an operation's floating output
    holds a NaN. Not checked: the outputs of the operations that
    allocate without writing (``empty``...), whose bytes are whatever
    the allocator held, and views, which compute nothing (a view of a
    buffer not yet written would read its garbage)."""

    _UNWRITTEN = ("empty", "new_empty", "empty_like", "empty_strided",
                  "new_empty_strided", "resize_", "set_")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.__name__.split(".")[0] in self._UNWRITTEN:
            return out
        leaves = out if isinstance(out, (tuple, list)) else (out,)
        for t in leaves:
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and t.numel() and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_checks(nans: bool = True) -> Iterator[None]:
    """Raise ``FloatingPointError`` at the first operation of the
    enclosed block that produces a NaN (``jax_debug_nans``); a no-op
    with ``nans=False``. Every operation reads a flag back to the host:
    slow, and not for a region under the sync guard."""
    if not nans:
        yield
        return
    try:
        with torch.autograd.detect_anomaly(check_nan=True), _NanCheck():
            yield
    except RuntimeError as e:
        # detect_anomaly's own report of a NaN-producing backward
        if "returned nan values" in str(e):
            raise FloatingPointError(
                f"invalid value (nan) encountered in backward: {e}") from e
        raise


class SectionTimer:
    """Cumulative host-side wall-clock per named section.

    >>> t = SectionTimer()
    >>> with t("rollout"): ...
    >>> t.report()  # {'rollout': 1.23}
    """

    def __init__(self):
        self._acc: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] = (self._acc.get(name, 0.0)
                               + time.perf_counter() - t0)

    def report(self) -> dict[str, float]:
        return dict(self._acc)
