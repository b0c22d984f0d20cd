"""Span-tracing flight recorder on the event bus.

The port's copy of the ``Tracer`` half of the JAX package's
``obs/trace.py`` (pure Python). The event bus records *points* ("this
happened at t"); this module records *extents*: a :class:`Tracer`
opens nestable, thread-aware spans (``with tracer.span("dispatch",
bucket=b):``) that land on the SAME JSONL stream as every other event --
paired ``span_begin`` / ``span_end`` records whose track is ``(rank,
thread)`` -- and zero-duration ``span_point`` instants (a request's
enqueue, a dispatch's served record). The readers of those records
(``build_span_tree``, ``async_overlap_summary``, ``to_chrome_trace``)
wait for the observability slice of the port (``ROADMAP.md`` queue 1,
item 24); the records already carry every field they read.

Design constraints, in order:

- **Zero device syncs.** Span emission touches host clocks and a file
  only -- never a device value.
- **Near-zero overhead when disabled.** ``span()`` on a disabled tracer
  returns one shared reusable no-op context -- no generator, no
  allocation, no lock. Callers hold :data:`NULL_TRACER` when no
  telemetry is attached, so the hot path never branches on ``None``.
- **Thread-aware.** A dispatcher thread and the caller's thread may
  emit on one bus concurrently; the bus write is serialized by
  :class:`.events.EventBus`'s emit lock, and each thread gets a stable
  small ``tid`` so stack discipline (begin/end pairing) holds *per
  track*.

A crash mid-span leaves a ``span_begin`` with no ``span_end`` (a *torn*
span); readers render it as an open span.
"""
from __future__ import annotations

import threading
from typing import Any

from .events import EventBus

# the bus kinds the tracer owns
SPAN_BEGIN = "span_begin"
SPAN_END = "span_end"
SPAN_POINT = "span_point"
SPAN_KINDS = (SPAN_BEGIN, SPAN_END, SPAN_POINT)


class _Span:
    """One live span: begin on enter, end on exit. Exceptions propagate
    (the end event still lands — a failed span is still an extent)."""

    __slots__ = ("_tracer", "_name", "_attrs")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> "_Span":
        self._tracer._begin(self._name, self._attrs)
        return self

    def __exit__(self, *exc) -> None:
        self._tracer._end(self._name)


class _NullSpan:
    """Shared reusable no-op context for the disabled path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-aware span emitter over one rank's :class:`EventBus`.

    >>> tracer = Tracer(bus, enabled=True)
    >>> with tracer.span("iteration", iteration=3):
    ...     with tracer.span("step"):
    ...         ...

    ``tid`` is a small per-process thread index (0 = first emitting
    thread), stamped on every span event so the merged timeline keeps
    one B/E stack per ``(rank, tid)`` track; the thread's *name* rides
    the begin event for Perfetto track labels. Attrs must be
    JSON-serializable and are carried under one ``attrs`` key so they
    can never shadow the bus's stamp fields.
    """

    def __init__(self, bus: EventBus | None, enabled: bool = True):
        self.bus = bus
        self.enabled = bool(enabled) and bus is not None
        self._lock = threading.Lock()          # protects _tids only
        self._tids: dict[int, int] = {}
        self._local = threading.local()

    def _track(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _depth(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **attrs: Any) -> Any:
        """Context manager for one span; no-op (one shared object, no
        allocation) when the tracer is disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def instant(self, name: str, **attrs: Any) -> None:
        """A zero-duration mark on this thread's track (Chrome ``i``
        event) — e.g. a serve request's enqueue point."""
        if not self.enabled:
            return
        assert self.bus is not None
        self.bus.emit(SPAN_POINT, span=name, tid=self._track(),
                      **({"attrs": attrs} if attrs else {}))

    def _begin(self, name: str, attrs: dict) -> None:
        assert self.bus is not None
        stack = self._depth()
        self.bus.emit(SPAN_BEGIN, span=name, tid=self._track(),
                      depth=len(stack),
                      thread=threading.current_thread().name,
                      **({"attrs": attrs} if attrs else {}))
        stack.append(name)

    def _end(self, name: str) -> None:
        assert self.bus is not None
        stack = self._depth()
        if stack and stack[-1] == name:
            stack.pop()
        self.bus.emit(SPAN_END, span=name, tid=self._track(),
                      depth=len(stack))

    def lane(self, label: str) -> "TracerLane":
        """A named VIRTUAL track on this tracer — a dedicated ``tid``
        that is not any OS thread's, labeled ``label`` in Perfetto.

        A multi-engine router gives every inference engine its own lane:
        engine spans (``pad``/``dispatch``) land on per-engine tracks,
        so a routed timeline shows which chip served which batch even
        though the dispatching happens from whichever pump thread won
        the request — exactly the track-per-resource (not
        track-per-thread) layout GPU rows use in Chrome traces. Each
        call returns a NEW lane (one per engine, allocated at router
        construction, never per dispatch — tids must stay stable).
        Disabled tracers return the shared no-op lane."""
        if not self.enabled:
            return NULL_LANE
        with self._lock:
            # virtual lanes share the tid space with real threads; the
            # key can never collide with threading.get_ident() values
            tid = len(self._tids)
            self._tids[("lane", label, tid)] = tid
        return TracerLane(self, label, tid)


class TracerLane:
    """One virtual track of a :class:`Tracer` (see :meth:`Tracer.lane`).

    Mirrors the ``span``/``instant`` API; B/E pairing discipline holds
    per lane via the lane's own depth stack (lock-guarded — concurrent
    pump threads may dispatch on one engine's lane under queue
    pressure)."""

    def __init__(self, tracer: Tracer, label: str, tid: int):
        self._tracer = tracer
        self.label = label
        self.tid = tid
        self._stack: list[str] = []
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self._tracer.enabled

    def span(self, name: str, **attrs: Any) -> Any:
        if not self._tracer.enabled:
            return _NULL_SPAN
        return _LaneSpan(self, name, attrs)

    def instant(self, name: str, **attrs: Any) -> None:
        if not self._tracer.enabled:
            return
        assert self._tracer.bus is not None
        self._tracer.bus.emit(SPAN_POINT, span=name, tid=self.tid,
                              **({"attrs": attrs} if attrs else {}))

    def _begin(self, name: str, attrs: dict) -> None:
        assert self._tracer.bus is not None
        with self._lock:
            depth = len(self._stack)
            self._stack.append(name)
        self._tracer.bus.emit(SPAN_BEGIN, span=name, tid=self.tid,
                              depth=depth, thread=self.label,
                              **({"attrs": attrs} if attrs else {}))

    def _end(self, name: str) -> None:
        assert self._tracer.bus is not None
        with self._lock:
            if self._stack and self._stack[-1] == name:
                self._stack.pop()
            depth = len(self._stack)
        self._tracer.bus.emit(SPAN_END, span=name, tid=self.tid,
                              depth=depth)


class _LaneSpan:
    """One live span on a virtual lane (same contract as :class:`_Span`)."""

    __slots__ = ("_lane", "_name", "_attrs")

    def __init__(self, lane: TracerLane, name: str, attrs: dict):
        self._lane = lane
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> "_LaneSpan":
        self._lane._begin(self._name, self._attrs)
        return self

    def __exit__(self, *exc) -> None:
        self._lane._end(self._name)


class _NullLane:
    """Shared no-op lane for disabled tracers."""

    __slots__ = ()
    enabled = False
    label = ""
    tid = 0

    def span(self, name: str, **attrs: Any) -> Any:
        return _NULL_SPAN

    def instant(self, name: str, **attrs: Any) -> None:
        pass


NULL_LANE = _NullLane()


# the always-available disabled tracer: run loops hold it when no
# telemetry (or no --trace) is attached, so call sites never branch
NULL_TRACER = Tracer(None, enabled=False)
