"""Run-loop telemetry of the port: iteration spans and production alarms.

Counterpart of the JAX package's ``obs/telemetry.py`` (``AlarmError``,
``Alarms``, ``RunTelemetry``, ``PROM_SNAPSHOT``, and the async engine's
``OverlapMeter`` and ``AsyncGauges``, plain Python copied as they are),
with its metric names, event kinds and fields, so either package's
``obs.report`` reads the other's runs.

:class:`RunTelemetry` is what the train loops hold -- one object owning
the event bus (:mod:`.events`), the counters/gauges registry
(:mod:`.metrics`), the host-side phase timer
(``utils.profiling.SectionTimer``), the span tracer and, opt-in, the
:class:`Alarms`.

Host-sync discipline: telemetry never touches device values. Phase
timings are host clocks; the ``iteration`` event is emitted only at
logged iterations, carrying the metrics dict the run loop already read
in its one batched host read, so an instrumented run makes the same
host reads as a bare one.

:class:`Alarms` runs the port's sentinels (:mod:`..analysis.sentinels`)
in production:

- **recompile** -- a ``CompileCounter`` spans the run; a program build
  (a CUDA-graph capture on the card, an eager build on the CPU,
  reported through ``note_build``) during a post-warmup dispatch emits
  a ``recompile`` event and bumps a counter. Warmup builds and the
  builds of a dispatch granted amnesty (:meth:`Alarms.expect_recompile`)
  land as ``compile`` events. The eager train step builds no program, so
  a port run has no warmup ``compile`` event where a JAX run has one;
- **transfer** -- post-warmup dispatches run under the sync guard
  (``no_implicit_transfers``: ``torch.cuda.set_sync_debug_mode("error")``
  on the card, nothing on the CPU): a host<->device synchronization in
  the hot path emits a ``transfer`` event and raises
  :class:`AlarmError`. A deliberate read inside a dispatch goes through
  ``analysis.sentinels.intended_sync``;
- **slow_iteration** -- optionally, an iteration whose wall time exceeds
  ``slow_iter_s`` emits the event and arms a one-shot torch profiler
  capture (:class:`..utils.profiling.TraceSession`) of the NEXT
  iteration (the slow one has already happened).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Callable, Iterator, Mapping

import torch

from ..analysis.sentinels import (CompileCounter, intended_sync,
                                  no_implicit_transfers)
from ..utils.profiling import SectionTimer, TraceSession
from .events import EventBus
from .metrics import Registry
from .trace import Tracer

PROM_SNAPSHOT = "metrics.prom"
# the text of the error torch raises under set_sync_debug_mode("error")
SYNC_ERROR = "synchronizing cuda operation"


class AlarmError(RuntimeError):
    """A production alarm that cannot be survived in place (a host sync
    inside a guarded dispatch)."""


class Alarms:
    """Production alarm scope. Use as a context manager spanning the run;
    wrap each dispatch in :meth:`dispatch`.

    ``warmup_iters`` dispatches are exempt from the guard; a build
    inside them is still recorded, as a ``compile`` event.
    ``expect_recompile(reason)`` grants the next dispatch the same
    amnesty. ``device`` is where the dispatches run: the sync guard acts
    on a CUDA device only, and the slow-iteration capture profiles it.
    """

    def __init__(self, bus: EventBus, registry: Registry | None = None,
                 warmup_iters: int = 1, transfer_guard: bool = True,
                 slow_iter_s: float | None = None,
                 profile_dir: str | None = None,
                 device: "torch.device | str" = "cuda"):
        if warmup_iters < 0:
            raise ValueError(f"warmup_iters must be >= 0, got "
                             f"{warmup_iters}")
        self.bus = bus
        self.registry = registry if registry is not None else Registry()
        self.warmup_iters = warmup_iters
        self.transfer_guard = transfer_guard
        self.slow_iter_s = slow_iter_s
        self.profile_dir = profile_dir
        self.device = torch.device(device)
        self._counter: CompileCounter | None = None
        self._dispatches = 0
        self._watches = 0
        self._lock = threading.Lock()
        self._amnesty: str | None = None
        self._profile_pending = False
        self._profile: TraceSession | None = None
        self._profile_done = False
        self._recompiles = self.registry.counter(
            "rlsched_recompile_alarms_total",
            "post-warmup dispatches that traced or compiled")
        self._transfers = self.registry.counter(
            "rlsched_transfer_alarms_total",
            "implicit host-device transfers caught in the hot path")
        self._slow = self.registry.counter(
            "rlsched_slow_iteration_alarms_total",
            "iterations slower than the slow_iter_s threshold")

    def __enter__(self) -> "Alarms":
        self._counter = CompileCounter().__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.stop_profile()
        if self._counter is not None:
            self._counter.__exit__(*exc)
            self._counter = None

    def expect_recompile(self, reason: str) -> None:
        """Grant the NEXT dispatch build amnesty (e.g. the first cell of
        a matrix row whose observation space differs)."""
        self._amnesty = reason

    @contextlib.contextmanager
    def dispatch(self, iteration: int) -> Iterator[None]:
        """Wrap one dispatch: count the program builds attributable to it
        and (post-warmup) forbid host syncs."""
        if self._counter is None:
            raise ValueError("Alarms.dispatch outside the context "
                             "(enter the Alarms scope first)")
        warm = self._dispatches < self.warmup_iters
        amnesty, self._amnesty = self._amnesty, None
        self._dispatches += 1
        t0 = self._counter.total
        with self._transfer_scope(
                iteration, self.transfer_guard and not warm
                and amnesty is None):
            yield
        compiles = self._counter.total - t0
        if compiles <= 0:
            return
        if warm or amnesty is not None:
            self.bus.emit("compile", iteration=iteration, events=compiles,
                          warmup=warm, expected=amnesty)
        else:
            self._recompiles.inc()
            self.bus.emit("recompile", iteration=iteration,
                          events=compiles)

    @contextlib.contextmanager
    def watch(self, iteration: int) -> Iterator[None]:
        """The sync guard over a peer thread's work beside the dispatches
        (the async engine's actor rollout): past its own first
        ``warmup_iters`` scopes, a host sync inside is a transfer alarm,
        as in :meth:`dispatch`. It counts no dispatch and attributes no
        build (the process-wide counter still sees them)."""
        with self._lock:
            warm = self._watches < self.warmup_iters
            self._watches += 1
        with self._transfer_scope(iteration,
                                  self.transfer_guard and not warm):
            yield

    @contextlib.contextmanager
    def _transfer_scope(self, iteration: int, guarded: bool
                        ) -> Iterator[None]:
        guard = (no_implicit_transfers(self.device) if guarded
                 else contextlib.nullcontext())
        try:
            with guard:
                yield
        except Exception as e:
            msg = str(e)
            if SYNC_ERROR in msg.lower():
                with self._lock:
                    self._transfers.inc()
                self.bus.emit("transfer", iteration=iteration,
                              error=msg[:500])
                raise AlarmError(
                    f"implicit host<->device transfer in the iteration-"
                    f"{iteration} dispatch (transfer alarm): {msg}") from e
            raise

    def observe_wall(self, iteration: int, wall_s: float) -> None:
        """Slow-iteration trigger: emit the alarm and arm a one-shot
        profiler capture of the next iteration."""
        if self.slow_iter_s is None or wall_s <= self.slow_iter_s:
            return
        self._slow.inc()
        self.bus.emit("slow_iteration", iteration=iteration,
                      wall_s=round(wall_s, 6),
                      threshold_s=self.slow_iter_s)
        if self.profile_dir is not None and not self._profile_done:
            self._profile_pending = True

    def maybe_start_profile(self) -> None:
        if not self._profile_pending or self._profile is not None:
            return
        self._profile = TraceSession(self.profile_dir, self.device).start()
        self._profile_pending = False

    def stop_profile(self, iteration: int | None = None) -> None:
        if self._profile is None:
            return
        # the capture's stop waits for the card: a deliberate sync (a
        # peer thread may hold the guard, as the async actor does)
        with intended_sync():
            self._profile.stop()
        self._profile = None
        self._profile_done = True   # one capture per run
        self.bus.emit("profile_captured", iteration=iteration,
                      profile_dir=self.profile_dir)


class RunTelemetry:
    """Everything a run loop needs, in one handle.

    >>> with RunTelemetry(obs_dir, alarms=True) as tel:
    ...     exp.run(iterations=100, log_every=10, telemetry=tel)

    The loop protocol (``Experiment.run`` / ``PopulationExperiment.run``
    implement it): ``run_start`` once; per iteration ``begin_iteration``
    -> ``dispatch`` around the train step -> phase work under
    ``sections(name)`` -> ``end_iteration`` (metrics dict only when the
    loop read one -- logged iterations); ``run_end`` once. Everything is
    host-side; no device value is ever touched here. ``device`` is the
    run's device (the alarms' guard and capture act on it).
    """

    def __init__(self, obs_dir: str, rank: int = 0, alarms: bool = False,
                 slow_iter_s: float | None = None, trace: bool = False,
                 device: "torch.device | str" = "cuda"):
        self.obs_dir = obs_dir
        self.bus = EventBus(obs_dir, rank=rank)
        self.registry = Registry()
        self.sections = SectionTimer()
        # disabled, the tracer hands out one shared no-op context per
        # span: the run loops thread it unconditionally
        self.tracer = Tracer(self.bus, enabled=trace)
        self.alarms = (Alarms(self.bus, self.registry,
                              slow_iter_s=slow_iter_s,
                              profile_dir=os.path.join(obs_dir, "profile"),
                              device=device)
                       if alarms else None)
        self._iterations = self.registry.counter(
            "rlsched_iterations_total", "train iterations completed")
        self._env_steps = self.registry.counter(
            "rlsched_env_steps_total", "environment steps completed")
        self._steps_per_sec = self.registry.gauge(
            "rlsched_env_steps_per_sec",
            "cumulative env-steps/sec over the run (monotonic clock)")
        self._t_run = time.monotonic()
        self._t_iter: float | None = None
        self._iter_span: Any = None
        self._last_sections: dict[str, float] = {}
        self.prom_path = os.path.join(obs_dir, PROM_SNAPSHOT)

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "RunTelemetry":
        if self.alarms is not None:
            self.alarms.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.alarms is not None:
            self.alarms.__exit__(*exc)
        self.close()

    def close(self) -> None:
        self.registry.write(self.prom_path)
        self.bus.close()

    def emit(self, kind: str, **fields: Any) -> None:
        self.bus.emit(kind, **fields)

    def run_start(self, **info: Any) -> None:
        self.bus.emit("run_start", **info)

    def run_end(self, **info: Any) -> None:
        self.bus.emit("run_end", phase_seconds=self._rounded_sections(),
                      **info)
        self.registry.write(self.prom_path)

    # -- per-iteration protocol -------------------------------------------
    def begin_iteration(self, iteration: int) -> None:
        self._t_iter = time.monotonic()
        if self.tracer.enabled:
            # the per-iteration span: the phase spans the loop opens
            # (step/sync/eval/ckpt/resample) nest under it
            self._iter_span = self.tracer.span("iteration",
                                               iteration=iteration)
            self._iter_span.__enter__()
        if self.alarms is not None:
            self.alarms.maybe_start_profile()

    def _close_iter_span(self) -> None:
        if self._iter_span is not None:
            self._iter_span.__exit__(None, None, None)
            self._iter_span = None

    @contextlib.contextmanager
    def dispatch(self, iteration: int) -> Iterator[None]:
        if self.alarms is None:
            yield
            return
        with self.alarms.dispatch(iteration):
            yield

    def end_iteration(self, iteration: int,
                      metrics: Mapping[str, Any] | None = None,
                      env_steps: int = 0) -> None:
        """Close the span opened by :meth:`begin_iteration`. ``metrics``
        is the host dict a logged iteration already read (or None
        between log points -- no event, no sync, just bookkeeping)."""
        wall = (time.monotonic() - self._t_iter
                if self._t_iter is not None else 0.0)
        self._t_iter = None
        self._close_iter_span()
        self._iterations.inc()
        self._env_steps.inc(env_steps)
        dt = time.monotonic() - self._t_run
        if dt > 0:
            self._steps_per_sec.set(self._env_steps.value / dt)
        if self.alarms is not None:
            self.alarms.stop_profile(iteration)
            self.alarms.observe_wall(iteration, wall)
        if metrics is None:
            return
        self.bus.emit("iteration", iteration=iteration,
                      wall_s=round(wall, 6), phases=self._section_delta(),
                      steps_per_sec=round(self._steps_per_sec.value, 3),
                      metrics={k: v for k, v in metrics.items()})
        self.registry.write(self.prom_path)

    def iteration_aborted(self, iteration: int, reason: str) -> None:
        """A rollback retry abandoned this iteration: settle its span
        without an event (the watchdog emits its own ``rollback``), stop
        a slow-iteration capture and grant the retry's step amnesty (its
        optimizer state is the restored one; a step that builds nothing
        emits nothing)."""
        self._t_iter = None
        self._close_iter_span()
        if self.alarms is not None:
            self.alarms.stop_profile(iteration)
            self.alarms.expect_recompile(reason)

    def expect_recompile(self, reason: str) -> None:
        if self.alarms is not None:
            self.alarms.expect_recompile(reason)

    # -- internals ---------------------------------------------------------
    def _rounded_sections(self) -> dict[str, float]:
        return {k: round(v, 6) for k, v in self.sections.report().items()}

    def _section_delta(self) -> dict[str, float]:
        """Per-phase seconds since the previous ``iteration`` event (the
        span breakdown), from the cumulative SectionTimer."""
        now = self.sections.report()
        delta = {k: round(v - self._last_sections.get(k, 0.0), 6)
                 for k, v in now.items()}
        self._last_sections = now
        for phase, secs in delta.items():
            self.registry.counter(
                f"rlsched_phase_{phase}_seconds_total",
                f"host wall seconds spent in the {phase} phase").inc(
                max(secs, 0.0))
        return delta


class OverlapMeter:
    """Online wall-clock overlap between two busy lanes (the async
    engine's actor and learner threads).

    Each lane opens/closes spans via :meth:`span`; the meter credits the
    intersection of concurrently-open spans to ``overlap_s``, each
    overlapping interval exactly once: when a span ENDS, it claims the
    intersection with the other lane's open span and advances that
    lane's credit frontier past the claimed interval, so the other
    lane's own end event cannot re-claim it. Thread-safe (one lock;
    span bookkeeping is O(1)) and clock-injectable for tests.

    This is the CI smoke stage's "nonzero overlap" evidence: even on a
    single core, the two threads' spans interleave around device waits,
    so a genuinely overlapped engine shows ``overlap_s > 0`` while a
    serialized one shows ~0.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._open: dict[str, float] = {}      # lane -> actual span start
        self._frontier: dict[str, float] = {}  # lane -> uncredited start
        self.busy_s: dict[str, float] = {}
        self.overlap_s = 0.0

    @contextlib.contextmanager
    def span(self, lane: str) -> Iterator[None]:
        t0 = self._clock()
        with self._lock:
            self._open[lane] = t0
            self._frontier[lane] = t0
        try:
            yield
        finally:
            t1 = self._clock()
            with self._lock:
                start = self._open.pop(lane, t1)
                self.busy_s[lane] = (self.busy_s.get(lane, 0.0)
                                     + (t1 - start))
                mine = self._frontier.pop(lane, start)
                for other in self._open:
                    lo = max(mine, self._frontier[other])
                    if t1 > lo:
                        self.overlap_s += t1 - lo
                        self._frontier[other] = t1

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            out = {f"busy_{k}_s": round(v, 6)
                   for k, v in self.busy_s.items()}
            out["overlap_s"] = round(self.overlap_s, 6)
            return out


class AsyncGauges:
    """The async engine's metric surface on a :class:`.metrics.Registry`:
    ``queue_depth``, ``param_staleness``,
    ``actor_idle_s``, ``learner_idle_s``, plus the overlap headline.
    Only the learner (caller) thread writes these — the actor thread
    hands its numbers over through the engine's lock-protected state, so
    the Registry never sees concurrent writers."""

    def __init__(self, registry: Registry):
        self.queue_depth = registry.gauge(
            "rlsched_async_queue_depth",
            "trajectory batches waiting in the actor->learner queue")
        self.param_staleness = registry.gauge(
            "rlsched_async_param_staleness",
            "policy-versions behind of the last consumed batch")
        self.actor_idle = registry.gauge(
            "rlsched_async_actor_idle_s",
            "cumulative seconds the actor spent blocked (staleness gate "
            "+ full-queue backpressure)")
        self.learner_idle = registry.gauge(
            "rlsched_async_learner_idle_s",
            "cumulative seconds the learner spent waiting on an empty "
            "queue")
        self.overlap = registry.gauge(
            "rlsched_async_overlap_s",
            "cumulative wall seconds actor and learner were busy "
            "simultaneously")
        self.rho_mean = registry.gauge(
            "rlsched_async_importance_ratio_mean",
            "mean unclipped importance ratio of the last logged update "
            "(1.0 = on-policy; the V-trace off-policyness monitor)")
        self.rho_max = registry.gauge(
            "rlsched_async_importance_ratio_max",
            "max unclipped importance ratio seen at any logged update "
            "this run")

    def publish(self, *, queue_depth: int, staleness: int,
                actor_idle_s: float, learner_idle_s: float,
                overlap_s: float, importance_ratio_mean: float = 1.0,
                importance_ratio_max: float = 1.0) -> None:
        self.queue_depth.set(queue_depth)
        self.param_staleness.set(staleness)
        self.actor_idle.set(round(actor_idle_s, 6))
        self.learner_idle.set(round(learner_idle_s, 6))
        self.overlap.set(round(overlap_s, 6))
        self.rho_mean.set(round(importance_ratio_mean, 6))
        self.rho_max.set(round(importance_ratio_max, 6))
