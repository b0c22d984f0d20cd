"""Runtime performance sentinels of the port: program-build counting
and the device-sync guard.

Counterparts of the JAX package's ``analysis/sentinels.py``. JAX counts
XLA traces and backend compiles through ``jax.monitoring`` listeners,
and guards hot loops with ``jax.transfer_guard("disallow")``. The port
compiles nothing: its one "program" per serving key is a CUDA graph
captured on the card (an eager build on the CPU), so

- :class:`CompileCounter` counts the port's own program builds through
  a module-level hook, :func:`note_build`, which the code that builds
  a program calls (``serve.engine.InferenceEngine`` does, once per
  capture or CPU build). It is not a torch compile listener;
- :func:`no_implicit_transfers` is ``torch.cuda.set_sync_debug_mode(
  "error")`` scoped as a context: inside it, any operation that makes
  the host wait for the card (``.item()``, a blocking copy either way,
  ``Stream.synchronize``) raises, while ``non_blocking`` copies, graph
  replays and waits on a ``torch.cuda.Event`` stay legal. The mode is
  process-wide, so the guard is refcounted across threads: the first
  thread in sets it, the last one out restores it. JAX's guard forbids
  only *implicit* transfers, so an explicit ``jax.device_get`` passes
  it; torch's mode cannot tell an intended read from an accident, so a
  deliberate read inside the guard goes through :func:`intended_sync`.
"""
from __future__ import annotations

import contextlib
import threading

import torch

# kinds note_build accepts: a CUDA-graph capture on the card, an eager
# program build (the first dispatch of a key) on the CPU
CAPTURE = "capture"
BUILD = "build"

_lock = threading.Lock()
_active: "list[CompileCounter]" = []


class RecompileSentinelError(AssertionError):
    """A region that must be build-free built or captured a program."""


def note_build(kind: str) -> None:
    """Report one program build (``CAPTURE`` or ``BUILD``) to every
    :class:`CompileCounter` in scope, in any thread."""
    if kind not in (CAPTURE, BUILD):
        raise ValueError(f"unknown build kind {kind!r}")
    with _lock:
        for c in _active:
            c._note(kind)


class CompileCounter:
    """Context manager counting program builds in its scope::

        engine.warmup(obs, mask)               # builds once per bucket
        with CompileCounter() as c:
            for n in sizes:
                engine.decide(obs[:n], mask[:n])
        assert c.total == 0, c.events

    Counts are global to the process, as JAX's are: a build in another
    thread during the scope counts too."""

    def __init__(self):
        self.captures = 0
        self.builds = 0
        self.events: list[str] = []

    @property
    def total(self) -> int:
        return self.captures + self.builds

    def _note(self, kind: str) -> None:
        if kind == CAPTURE:
            self.captures += 1
        else:
            self.builds += 1
        self.events.append(kind)

    def __enter__(self) -> "CompileCounter":
        with _lock:
            _active.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _lock:
            _active.remove(self)


@contextlib.contextmanager
def assert_no_recompiles(what: str = "region"):
    """Assert a region builds and captures no program (post-warmup
    steady state). Raises :class:`RecompileSentinelError` naming the
    events."""
    with CompileCounter() as counter:
        yield counter
    if counter.total > 0:
        raise RecompileSentinelError(
            f"{what} expected no program build but saw "
            f"{counter.captures} CUDA-graph capture(s) and "
            f"{counter.builds} build(s): a geometry-stable hot loop is "
            f"rebuilding (a new row shape or dtype, or a bucket the "
            f"warmup never saw)")


# the refcounted sync guard: threads inside it, and the mode it replaced
_guard_lock = threading.RLock()
_guard_depth = 0
_guard_prev = 0


@contextlib.contextmanager
def no_implicit_transfers(device: "torch.device | str" = "cuda"):
    """Inside, a host<->device synchronization on ``device`` raises.

    On a CUDA device this is ``torch.cuda.set_sync_debug_mode("error")``
    for the scope. Unlike ``jax.transfer_guard`` the mode is
    PROCESS-WIDE, not thread-local: while one thread is inside the
    guard, a synchronizing call on any other thread raises too. Several
    dispatcher threads may hold the guard at once: it is refcounted, so
    the first entry sets the mode and the last exit restores the one it
    found, and no thread turns it off under another. Code that runs
    beside serving dispatchers must therefore make no blocking call
    either (the engine waits on events and copies non-blocking). On the
    CPU there is no device to wait for: the context does nothing, on
    purpose."""
    global _guard_depth, _guard_prev
    if torch.device(device).type != "cuda":
        yield
        return
    with _guard_lock:
        if _guard_depth == 0:
            _guard_prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        _guard_depth += 1
    try:
        yield
    finally:
        with _guard_lock:
            _guard_depth -= 1
            if _guard_depth == 0:
                torch.cuda.set_sync_debug_mode(_guard_prev)


@contextlib.contextmanager
def intended_sync():
    """Let the enclosed deliberate host read through the sync guard (the
    port's counterpart of an explicit ``jax.device_get`` inside
    ``jax.transfer_guard("disallow")``); every other sync still raises.

    Outside the guard, or on a process with no card, it does nothing.
    Inside it, the scope restores the mode the guard replaced and puts
    ``"error"`` back on exit. The refcount is left as it is: every
    thread that holds the guard still holds it. Because the mode is
    process-wide, the scope lifts it for every thread, so it also holds
    the guard's lock throughout: no thread can enter or leave the guard
    meanwhile (they wait), and a sync that another thread makes inside
    this window is not caught. Keep the scope to the one read."""
    with _guard_lock:
        if _guard_depth == 0:
            yield
            return
        torch.cuda.set_sync_debug_mode(_guard_prev)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("error")
