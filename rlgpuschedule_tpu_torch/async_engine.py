"""Async actor-learner engine (L6) of the port: overlapped rollout and
update (Sebulba, PAPERS.md: arXiv 2104.06272).

Counterpart of the JAX package's ``async_engine.py``
(``StalenessError``, ``TrajectoryQueue``, ``AsyncRunner``,
``AsyncPopulationRunner``). The synchronous loop alternates rollout and
update; this engine runs them in two threads coupled by a bounded
trajectory queue:

- **actor thread**: waits for the drained-queue barriers before its
  batch, gates on the staleness bound, copies the freshest published
  parameters into a policy module of its own (a copy of the learner's,
  made at construction), runs ``algos.rollout.rollout`` and pushes the
  batch, blocking while the queue is full (backpressure, never a drop);
- **learner loop** (the caller's thread, so exceptions, logging and the
  checkpoint hooks behave as in ``Experiment.run``): pops batch ``i``,
  checks the staleness invariant, runs the algorithm's
  ``make_learn_step`` on the experiment's update generator, and
  publishes the fresh parameters.

**Staleness.** Batch ``i`` feeds update ``i``; after update ``i`` the
published version is ``i + 1``. The actor may not start batch ``i``
until ``version >= i - bound`` and always takes the freshest
publication, so ``staleness(i) = i - version_used(i) <= bound`` (the
learner checks it). ``bound = 0`` is lock-step: the actor draws from the
carry's generator and the learner from the update generator, each alone,
in the sync loop's order, so ``run_async`` at bound 0 is
``Experiment.run`` bit for bit.

**Two CUDA streams.** On the card the actor works on a stream of its own
and the learner on another (two streams of ``cuda:0`` on one H100):

- a queue item carries the batch and a ``torch.cuda.Event`` recorded on
  the actor's stream after the rollout; the learner's stream waits on it
  and every batch tensor gets ``record_stream(learner_stream)``, so the
  caching allocator cannot hand a block the learner still reads to the
  next rollout. Neither loop makes a host sync: the event is JAX's
  ``block_until_ready``;
- a publication is a clone of the learner's parameters made on the
  learner's stream and an event recorded after it; before each rollout
  the actor's stream waits on it, ``copy_``s the clone into its module
  and marks the clone ``record_stream(actor_stream)``;
- the tensors the actor reads from the build (traces, carry, schedules)
  are marked for its stream too, and a window resample at a barrier runs
  on the actor's stream, which consumes its windows and carry.

Thread-local state: the actor thread enters its own stream (and so its
device); grad mode is per thread, and ``rollout`` is ``no_grad``. The
actor draws only from ``carry.generator`` and the learner only from
``exp.generator``; neither touches a default generator. JAX serializes
device dispatch behind a lock on the CPU (XLA:CPU is not safe against
two executing threads); PyTorch's CPU kernels are, and the port takes
no such lock: on the CPU the two threads' work overlaps too.

**Barriers.** Checkpoints and window resamples need a drained queue
(the carry and the windows are shared). Both loops compute the barrier
set up front; at a barrier the actor parks after collecting that batch
and the learner updates through it, saves or resamples, then releases
the actor. Cadences count iterations over the experiment's life, as
``Experiment.run``'s do (JAX counts each call from 0): a resample due
before the call's first iteration runs before the actor starts, and one
due after its last waits for the next call. A resample is
``Experiment.advance_windows``: the carry keeps its generator (JAX
re-keys it). Checkpoints gain ``async_iteration`` and
``staleness_bound`` in their meta.

**Telemetry** is JAX's, name for name: ``run_start`` with
``loop="async-experiment"``, ``run_end`` with the ``async_*`` keys,
the sections ``actor``, ``learner``, ``queue_wait``, ``sync``, ``eval``,
``ckpt``, ``resample`` (and ``pbt``), the spans
``actor_barrier_wait``, ``actor_gate_wait``, ``actor``,
``queue_push_wait``, ``queue_pop_wait``, ``learner`` and ``sync``, the
``rlsched_async_*`` gauges (:class:`.obs.telemetry.AsyncGauges`) and
:meth:`AsyncRunner.async_info`. With the alarms armed, the learner's
step runs inside ``telemetry.dispatch`` and the actor's rollout inside
``Alarms.watch`` (the sync guard, process-wide on the card); the
learner's deliberate reads between steps (the logged metrics, the
probe) go through ``analysis.sentinels.intended_sync``.

Device groups (:mod:`.parallel.groups`): a shared group on one device,
or one actor device against one learner device (the batch and the
parameters hop with ``.to(device, non_blocking=True)``; unverified on a
one-card machine). Wider groups wait for the data-parallel slice.

:class:`AsyncPopulationRunner` runs a :class:`.experiment
.PopulationExperiment` the same way: the actor rolls each member in turn
with its own carry, the learner updates each in turn, PBT
exploit/explore fires at barriers predicted from the controller's
window, and staleness is also tracked per member.
"""
from __future__ import annotations

import bisect
import contextlib
import copy
import dataclasses
import threading
import time
from typing import Any, Callable

import torch

from .algos import a2c, ppo
from .algos.rollout import (RolloutCarry, rollout,
                            validate_rollout_geometry)
from .algos.update import validate_update_geometry
from .analysis.sentinels import intended_sync
from .obs.telemetry import AsyncGauges, OverlapMeter
from .obs.trace import tracer_of
from .parallel.groups import (DeviceGroups, device_id, home_device,
                              split_devices)
from .tree import leaves, tree_map
from .utils.profiling import SectionTimer

# every blocking wait re-checks abort/progress at this period, and gives
# up (a clear RuntimeError instead of a silent hang) after stall_timeout_s
_WAIT_TICK_S = 0.2


class StalenessError(RuntimeError):
    """The learner was handed a batch older than the configured bound:
    an engine invariant violation (the actor gate should make this
    impossible), never a user error."""


class _Aborted(Exception):
    """Internal: unwind a loop after the other loop failed."""


@dataclasses.dataclass
class _QueueItem:
    index: int      # global batch index (== the update that consumes it)
    version: int    # policy version the batch was collected with
    batch: Any      # the rollout's output, on the learner's device
    ready: Any = None   # event on the actor's stream after the batch


class TrajectoryQueue:
    """Bounded blocking FIFO between the actor and learner loops.

    ``put`` blocks while the queue is at capacity (backpressure: a full
    queue slows the actor down, it never drops a batch); ``get`` blocks
    while empty. ``abort(exc)`` wakes every waiter: blocked
    ``put``/``get`` calls raise ``_Aborted`` so a failure in either loop
    unwinds the other instead of deadlocking it. Items hold device
    tensors, so the queue never copies: it is depth bookkeeping plus
    blocking semantics."""

    def __init__(self, capacity: int,
                 clock: Callable[[], float] = time.monotonic,
                 stall_timeout_s: float = 300.0):
        if capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._clock = clock
        self._stall_timeout_s = stall_timeout_s
        self._items: list[_QueueItem] = []
        self._cv = threading.Condition()
        self._abort_exc: BaseException | None = None

    def __len__(self) -> int:
        with self._cv:
            return len(self._items)

    def abort(self, exc: BaseException) -> None:
        with self._cv:
            if self._abort_exc is None:
                self._abort_exc = exc
            self._cv.notify_all()

    def _wait(self, ready: Callable[[], bool], what: str) -> float:
        """Wait until ``ready()`` under the held condition; returns the
        seconds spent blocked."""
        t0 = self._clock()
        while not ready():
            if self._abort_exc is not None:
                raise _Aborted() from self._abort_exc
            if self._clock() - t0 > self._stall_timeout_s:
                raise RuntimeError(
                    f"TrajectoryQueue.{what} stalled for more than "
                    f"{self._stall_timeout_s}s (deadlocked peer loop?)")
            self._cv.wait(_WAIT_TICK_S)
        if self._abort_exc is not None:
            raise _Aborted() from self._abort_exc
        return self._clock() - t0

    def put(self, item: _QueueItem) -> float:
        """Blocking append; returns seconds spent in backpressure."""
        with self._cv:
            waited = self._wait(
                lambda: len(self._items) < self.capacity, "put")
            self._items.append(item)
            self._cv.notify_all()
            return waited

    def get(self) -> tuple[_QueueItem, float]:
        """Blocking pop; returns (item, seconds spent waiting)."""
        with self._cv:
            waited = self._wait(lambda: len(self._items) > 0, "get")
            item = self._items.pop(0)
            self._cv.notify_all()
            return item, waited


class _ParamSlot:
    """The published-params mailbox: the learner publishes ``(params,
    version)`` (the port's params: a :class:`_Publication`); the actor
    waits for a minimum version and always reads the freshest
    publication."""

    def __init__(self, params: Any, version: int,
                 clock: Callable[[], float] = time.monotonic,
                 stall_timeout_s: float = 300.0):
        self._params = params
        self._version = version
        self._clock = clock
        self._stall_timeout_s = stall_timeout_s
        self._cv = threading.Condition()
        self._abort = False

    @property
    def version(self) -> int:
        with self._cv:
            return self._version

    def abort(self) -> None:
        with self._cv:
            self._abort = True
            self._cv.notify_all()

    def publish(self, params: Any, version: int) -> None:
        with self._cv:
            self._params = params
            self._version = version
            self._cv.notify_all()

    def wait_for(self, min_version: int) -> tuple[Any, int, float]:
        """Block until ``version >= min_version``; returns (freshest
        params, their version, seconds spent gated)."""
        t0 = self._clock()
        with self._cv:
            while self._version < min_version:
                if self._abort:
                    raise _Aborted()
                if self._clock() - t0 > self._stall_timeout_s:
                    raise RuntimeError(
                        f"staleness gate stalled waiting for version "
                        f">= {min_version} (have {self._version})")
                self._cv.wait(_WAIT_TICK_S)
            if self._abort:
                raise _Aborted()
            return self._params, self._version, self._clock() - t0


@dataclasses.dataclass
class _Publication:
    """Clones of the learner's parameters on the actor's device (one
    list per policy) and the event after them on the learner's stream
    (None on the CPU)."""
    params: list
    ready: Any


def _tensors(tree) -> list:
    return [x for x in leaves(tree) if isinstance(x, torch.Tensor)]


class _Lane:
    """One role's device and, on a CUDA device, its own stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def context(self):
        """Make this lane's stream (and device) current in the thread."""
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def mark(self):
        """An event recorded on the lane's stream now (None on the CPU)."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def wait(self, event) -> None:
        if event is not None:
            self.stream.wait_event(event)

    def hold(self, tensors) -> None:
        """Tell the caching allocator this lane's stream uses
        ``tensors`` (their blocks are not reused until it is done)."""
        if self.stream is not None:
            for t in tensors:
                t.record_stream(self.stream)

    def after_caller(self) -> None:
        """Order the lane after the calling thread's current stream."""
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def before_caller(self) -> None:
        """Order the calling thread's current stream after the lane."""
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)


def _move_carry(carry: RolloutCarry, dev: torch.device) -> RolloutCarry:
    """A carry on ``dev``, its generator re-homed with the same state."""
    gen = carry.generator
    if gen.device != dev:
        gen = torch.Generator(dev)
        gen.set_state(carry.generator.get_state())
    env_state, obs, mask = _to((carry.env_state, carry.obs, carry.mask),
                               dev)
    return RolloutCarry(env_state, obs, mask, gen)


def _to(tree, dev: torch.device):
    return tree_map(lambda x: x.to(dev, non_blocking=True)
                    if isinstance(x, torch.Tensor) else x, tree)


class _Engine:
    """What both runners share: the device lanes, the queue, the slot,
    the barriers, the accounting, and the two loops around the hooks a
    runner fills in (``_collect``, ``_update``, ``_after_update``,
    ``_row``, ``_barrier_work``)."""

    loop_name = ""
    thread_name = ""

    def _init_engine(self, policies, groups: DeviceGroups,
                     staleness_bound: int, queue_capacity: int,
                     stall_timeout_s: float) -> None:
        self.groups = groups
        self.staleness_bound = staleness_bound
        self.queue_capacity = queue_capacity
        self._stall_timeout_s = stall_timeout_s
        self._clock = time.monotonic
        self._actor = _Lane(groups.actor_device)
        self._learner = _Lane(groups.learner_device)
        self._learner.after_caller()
        # the actor's own policy modules, refreshed from each publication
        self._policies = [copy.deepcopy(p).to(groups.actor_device)
                          .requires_grad_(False) for p in policies]
        self._iterations_done = 0
        self._slot = _ParamSlot(self._publish(), version=0,
                                clock=self._clock,
                                stall_timeout_s=stall_timeout_s)
        self.queue = TrajectoryQueue(queue_capacity, clock=self._clock,
                                     stall_timeout_s=stall_timeout_s)
        self.overlap = OverlapMeter(clock=self._clock)
        self._bar_cv = threading.Condition()
        self._barriers: list[int] = []     # global iteration indices
        self._barriers_done = 0
        self._failure: BaseException | None = None
        # actor-thread-owned accounting, read by the learner at log points
        self._actor_idle_s = 0.0
        self._learner_idle_s = 0.0
        self._staleness_last = 0
        self._staleness_max = 0
        self._staleness_sum = 0
        self._consumed = 0
        # importance-ratio monitor, fed from the metrics already read at
        # log points (no extra host read): 1.0 is the on-policy value
        self._rho_last = 1.0
        self._rho_max_seen = 1.0

    # -- parameters ---------------------------------------------------------

    def _learner_params(self) -> list:
        """Each policy's parameters on the learner (runner hook)."""
        raise NotImplementedError

    def _publish(self) -> _Publication:
        """Clone the learner's parameters onto the actor's device on the
        learner's stream; the event marks when the clones are ready."""
        dev = self.groups.actor_device
        with self._learner.context(), torch.no_grad():
            params = [[p.detach().to(dev, non_blocking=True, copy=True)
                       for p in ps] for ps in self._learner_params()]
            return _Publication(params, self._learner.mark())

    def _load(self, pub: _Publication) -> None:
        """Actor side: copy a publication into the actor's modules, on
        the actor's stream after the clones are ready."""
        self._actor.wait(pub.ready)
        with torch.no_grad():
            for module, params in zip(self._policies, pub.params):
                for dst, src in zip(module.parameters(), params):
                    dst.copy_(src)
                self._actor.hold(params)

    # -- barrier plumbing ---------------------------------------------------

    def _wait_barriers_before(self, i: int) -> float:
        """Actor side: park until every barrier < global iteration ``i``
        has been completed by the learner. Returns seconds parked."""
        t0 = self._clock()
        with self._bar_cv:
            need = bisect.bisect_left(self._barriers, i)
            while self._barriers_done < need:
                if self._failure is not None:
                    raise _Aborted()
                if self._clock() - t0 > self._stall_timeout_s:
                    raise RuntimeError(
                        f"actor stalled at barrier before iteration {i}")
                self._bar_cv.wait(_WAIT_TICK_S)
        return self._clock() - t0

    def _complete_barrier(self) -> None:
        with self._bar_cv:
            self._barriers_done += 1
            self._bar_cv.notify_all()

    def _abort(self, exc: BaseException) -> None:
        # publish the failure under the barrier Condition: the learner
        # reads it there, and an unlocked write could be seen torn
        # against the notify
        with self._bar_cv:
            self._failure = exc
            self._bar_cv.notify_all()
        self.queue.abort(exc)
        self._slot.abort()

    # -- the actor loop (background thread) ---------------------------------

    def _actor_loop(self, base: int, iterations: int,
                    sections: SectionTimer, tracer, watch) -> None:
        try:
            with self._actor.context():
                for k in range(iterations):
                    i = base + k
                    # the flight recorder's actor track: the two wait
                    # spans and the push-side backpressure are the idle
                    # gaps; "actor" is the busy lane the measured-overlap
                    # summary unions against "learner"
                    with tracer.span("actor_barrier_wait"):
                        self._actor_idle_s += self._wait_barriers_before(i)
                    with tracer.span("actor_gate_wait"):
                        pub, version, gated = self._slot.wait_for(
                            i - self.staleness_bound)
                    self._actor_idle_s += gated
                    with tracer.span("actor", iteration=i), \
                            self.overlap.span("actor"), sections("actor"), \
                            watch(i):
                        self._load(pub)
                        batch = self._collect()
                        if not self.groups.shared:
                            batch = _to(batch, self.groups.learner_device)
                        ready = self._actor.mark()
                    with tracer.span("queue_push_wait"):
                        self._actor_idle_s += self.queue.put(_QueueItem(
                            index=i, version=version, batch=batch,
                            ready=ready))
        except _Aborted:
            pass
        except BaseException as e:  # surface in the learner thread
            self._abort(e)

    # -- the learner loop (caller thread) -----------------------------------

    def _publish_gauges(self, gauges) -> None:
        if gauges is not None:
            gauges.publish(queue_depth=len(self.queue),
                           staleness=self._staleness_last,
                           actor_idle_s=self._actor_idle_s,
                           learner_idle_s=self._learner_idle_s,
                           overlap_s=self.overlap.overlap_s,
                           importance_ratio_mean=self._rho_last,
                           importance_ratio_max=self._rho_max_seen)

    def _run(self, exp, iterations: int, log_every, logger, ckpt,
             ckpt_every, eval_every, eval_fn, eval_logger, telemetry,
             is_extra: Callable[[int], bool], start_info: dict) -> dict:
        """The learner loop over ``exp`` (an experiment or a population:
        ``iteration``, ``save_checkpoint``, ``steps_per_iteration``,
        ``_sync``); ``is_extra(k)`` names the runner's own barriers (a
        resample, an exploit round)."""
        g0 = exp.iteration
        base = self._iterations_done
        history: list[dict] = []
        eval_history: list[dict] = []
        sections = (telemetry.sections if telemetry is not None
                    else SectionTimer())
        gauges = (AsyncGauges(telemetry.registry)
                  if telemetry is not None else None)
        tracer = tracer_of(telemetry)
        alarms = telemetry.alarms if telemetry is not None else None
        watch = (alarms.watch if alarms is not None
                 else lambda i: contextlib.nullcontext())

        def is_ckpt(k: int) -> bool:
            return bool(ckpt is not None and ckpt_every
                        and ((g0 + k + 1) % ckpt_every == 0
                             or k == iterations - 1))

        local_barriers = [k for k in range(iterations)
                          if is_ckpt(k) or is_extra(k)]
        with self._bar_cv:
            self._barriers = [base + k for k in local_barriers]
            self._barriers_done = 0
            self._failure = None

        if telemetry is not None:
            telemetry.run_start(
                loop=self.loop_name, **start_info, iterations=iterations,
                steps_per_iteration=exp.steps_per_iteration,
                staleness_bound=self.staleness_bound,
                queue_capacity=self.queue_capacity,
                actor_devices=[device_id(d) for d in self.groups.actor],
                learner_devices=[device_id(d) for d in self.groups.learner],
                shared_group=self.groups.shared)

        exp._sync()
        t0 = time.perf_counter()
        # the state the caller left on its stream comes first on both
        self._learner.after_caller()
        self._actor.after_caller()
        self._hold_actor_state()
        actor = threading.Thread(
            target=self._actor_loop,
            args=(base, iterations, sections, tracer, watch),
            name=self.thread_name, daemon=True)
        actor.start()
        try:
            with self._learner.context():
                for k in range(iterations):
                    g = exp.iteration     # hook-facing, over the life
                    i = base + k
                    if telemetry is not None:
                        telemetry.begin_iteration(g)
                    with sections("queue_wait"), \
                            tracer.span("queue_pop_wait"):
                        item, waited = self.queue.get()  # jsan: disable=hung-future -- TrajectoryQueue.get is bounded by construction (stall timeout + abort wakes every waiter)
                    self._learner_idle_s += waited
                    if item.index != i:
                        raise RuntimeError(
                            f"queue order violation: expected batch {i}, "
                            f"got {item.index}")
                    staleness = item.index - item.version
                    if staleness > self.staleness_bound:
                        raise StalenessError(
                            f"batch {item.index} was collected at policy "
                            f"version {item.version} — {staleness} "
                            f"versions behind, bound is "
                            f"{self.staleness_bound}")
                    self._staleness_last = staleness
                    self._staleness_max = max(self._staleness_max,
                                              staleness)
                    self._staleness_sum += staleness
                    self._consumed += 1
                    self._note_staleness(staleness)
                    guard = (telemetry.dispatch(g) if telemetry is not None
                             else contextlib.nullcontext())
                    with tracer.span("learner", iteration=g), \
                            self.overlap.span("learner"), \
                            sections("learner"), guard:
                        self._learner.wait(item.ready)
                        self._learner.hold(_tensors(item.batch))
                        metrics = self._update(item.batch)
                        pub = self._publish()
                    exp.iteration = g + 1
                    self._slot.publish(pub, i + 1)
                    self._after_update(k, g, i, metrics, sections, tracer,
                                       telemetry)
                    last = k == iterations - 1
                    m = None
                    if log_every and (g % log_every == 0 or last):
                        # the one read of a logged iteration, deliberate
                        with sections("sync"), tracer.span("sync"), \
                                intended_sync():
                            m = self._row(metrics)
                        rho = self._rho(m)
                        if rho is not None:
                            self._rho_last = rho[0]
                            self._rho_max_seen = max(self._rho_max_seen,
                                                     rho[1])
                        history.append({"iteration": g, **m})
                        if logger is not None:
                            logger(g, m)
                        self._publish_gauges(gauges)
                    if eval_fn is not None and eval_every and \
                            ((g + 1) % eval_every == 0 or last):
                        with sections("eval"), tracer.span("eval"), \
                                intended_sync():
                            em = dict(eval_fn(g))
                        eval_history.append({"iteration": g, **em})
                        if eval_logger is not None:
                            eval_logger(g, em)
                    # drained-queue barrier work (the actor is parked)
                    if is_ckpt(k):
                        with sections("ckpt"), tracer.span("ckpt"):
                            exp.save_checkpoint(
                                ckpt, meta={"async_iteration": i,
                                            "staleness_bound":
                                                self.staleness_bound})
                    self._barrier_work(k, sections, tracer)
                    if is_ckpt(k) or is_extra(k):
                        self._complete_barrier()
                    if telemetry is not None:
                        telemetry.end_iteration(g, m,
                                                exp.steps_per_iteration)
                    if self._failure is not None:
                        raise self._failure
        except BaseException as e:
            self._abort(e)
            actor.join(timeout=30)
            raise
        actor.join(timeout=self._stall_timeout_s)
        if actor.is_alive():
            exc = RuntimeError("actor thread failed to drain")
            self._abort(exc)
            raise exc
        if self._failure is not None:
            raise self._failure
        self._learner.before_caller()
        self._actor.before_caller()
        exp._sync()
        self._iterations_done = base + iterations
        wall = time.perf_counter() - t0
        env_steps = iterations * exp.steps_per_iteration
        info = self.async_info()
        out = {"wall_s": wall, "iterations": iterations,
               "env_steps": env_steps,
               "env_steps_per_sec": env_steps / wall,
               **self._summary(),
               "history": history,
               "phase_seconds": {k2: round(v, 6)
                                 for k2, v in sections.report().items()},
               "async": info}
        if eval_history:
            out["eval_history"] = eval_history
        if telemetry is not None:
            self._publish_gauges(gauges)
            telemetry.run_end(
                iterations=iterations, wall_s=round(wall, 6),
                env_steps=env_steps,
                env_steps_per_sec=round(out["env_steps_per_sec"], 3),
                **self._end_info(),
                **{f"async_{k2}": v for k2, v in info.items()
                   if not isinstance(v, (list, dict))})
        return out

    # hooks with a default
    def _note_staleness(self, staleness: int) -> None:
        pass

    def _after_update(self, k, g, i, metrics, sections, tracer,
                      telemetry) -> None:
        pass

    def _barrier_work(self, k: int, sections, tracer) -> None:
        pass

    def _end_info(self) -> dict:
        return {}

    def async_info(self) -> dict:
        """The engine's overlap/staleness accounting so far."""
        snap = self.overlap.snapshot()
        return {
            "staleness_bound": self.staleness_bound,
            "queue_capacity": self.queue_capacity,
            "actor_devices": [device_id(d) for d in self.groups.actor],
            "learner_devices": [device_id(d) for d in self.groups.learner],
            "shared_group": self.groups.shared,
            "overlap_s": snap["overlap_s"],
            "actor_busy_s": snap.get("busy_actor_s", 0.0),
            "learner_busy_s": snap.get("busy_learner_s", 0.0),
            "actor_idle_s": round(self._actor_idle_s, 6),
            "learner_idle_s": round(self._learner_idle_s, 6),
            "staleness_max": self._staleness_max,
            "staleness_mean": (self._staleness_sum / self._consumed
                               if self._consumed else 0.0),
            "importance_ratio_mean": self._rho_last,
            "importance_ratio_max": self._rho_max_seen,
        }


def _check_bound(staleness_bound: int) -> None:
    if staleness_bound < 0:
        raise ValueError(f"staleness_bound must be >= 0, got "
                         f"{staleness_bound}")


def _groups_for(device: torch.device, groups: DeviceGroups | None
                ) -> DeviceGroups:
    """The runner's groups (default: both roles shared on the
    experiment's device), checked runnable and holding the experiment's
    device as the learner's (the train state stays where it is)."""
    if groups is None:
        groups = split_devices(devices=[home_device(device)])
    groups.check_runnable()
    if home_device(groups.learner_device) != home_device(device):
        raise ValueError(
            f"the learner group ({groups.describe()}) must hold the "
            f"experiment's device {device}: build the experiment on the "
            f"learner's device")
    return groups


class AsyncRunner(_Engine):
    """The assembled async engine over one :class:`.experiment.Experiment`.

    Construction copies the learner's policy for the actor and, on a
    split group, moves the actor's state (traces, carry, schedules) to
    the actor's device. ``run()`` may be called repeatedly; the version
    and batch counters continue.

    ``staleness_bound``: max policy versions a consumed batch may be
    behind (0 = the sync loop bit for bit). ``queue_capacity``: batches
    in flight past the gate (backpressure blocks the actor when full)."""

    loop_name = "async-experiment"
    thread_name = "async-actor"

    def __init__(self, exp, groups: DeviceGroups | None = None,
                 staleness_bound: int = 1, queue_capacity: int = 2,
                 stall_timeout_s: float = 300.0):
        from .experiment import algo_config
        _check_bound(staleness_bound)
        cfg = exp.cfg
        algo = algo_config(cfg)
        groups = _groups_for(exp.device, groups)
        # each phase checked against its own device group
        validate_rollout_geometry(algo.n_steps, cfg.n_envs,
                                  len(groups.actor))
        validate_update_geometry(algo.n_epochs, algo.n_minibatches,
                                 algo.minibatch_size, n_steps=algo.n_steps,
                                 n_envs=cfg.n_envs,
                                 n_devices=len(groups.learner))
        self.exp = exp
        self._n_steps = algo.n_steps
        lib = a2c if cfg.algo == "a2c" else ppo
        self._learn = lib.make_learn_step(algo)
        self._init_engine([exp.net], groups, staleness_bound,
                          queue_capacity, stall_timeout_s)
        self._adopt()

    def _adopt(self) -> None:
        """On a split group, the actor's state onto the actor's device."""
        if self.groups.shared:
            return
        exp, dev = self.exp, self.groups.actor_device
        exp.traces = _to(exp.traces, dev)
        exp.faults = _to(exp.faults, dev)
        exp.carry = _move_carry(exp.carry, dev)

    def _hold_actor_state(self) -> None:
        exp = self.exp
        self._actor.hold(_tensors((exp.traces, exp.faults, exp.carry)))

    def _learner_params(self) -> list:
        return [list(self.exp.net.parameters())]

    def _collect(self):
        exp = self.exp
        exp.carry, tr, last_value = rollout(
            self._policies[0], exp.env_params, exp.traces, exp.carry,
            self._n_steps, faults=exp.faults)
        return tr, last_value

    def _update(self, batch):
        exp = self.exp
        tr, last_value = batch
        exp.train_state, metrics = self._learn(exp.train_state, tr,
                                               last_value, exp.generator)
        return metrics

    def _row(self, metrics) -> dict:
        return dict(zip(type(metrics)._fields,
                        torch.stack(metrics).tolist()))

    @staticmethod
    def _rho(m: dict):
        """(mean, max) importance ratio of a logged row (A2C has none)."""
        return (m["rho_mean"], m["rho_max"]) if "rho_mean" in m else None

    def _summary(self) -> dict:
        return {"window_cursor": self.exp.window_cursor}

    def _resample(self) -> None:
        """Window streaming on the actor's stream (it consumes the
        windows and the carry), the actor parked or not yet started."""
        with self._actor.context():
            self.exp.advance_windows()
        self._adopt()

    def run(self, iterations: int | None = None, log_every: int = 0,
            logger: Callable[[int, dict], None] | None = None,
            ckpt=None, ckpt_every: int = 0,
            eval_every: int = 0,
            eval_fn: "Callable[[int], dict] | None" = None,
            eval_logger: Callable[[int, dict], None] | None = None,
            telemetry=None) -> dict:
        """Run ``iterations`` overlapped actor/learner iterations; the
        hook surface (log/ckpt/eval cadences over the experiment's life,
        telemetry protocol, summary dict) mirrors
        :meth:`.experiment.Experiment.run`. Window streaming
        (``cfg.resample_every``) and checkpoints run at drained-queue
        barriers."""
        exp = self.exp
        iterations = iterations or exp.cfg.iterations
        every = exp.cfg.resample_every
        g0 = exp.iteration
        if every and g0 and g0 % every == 0:
            # due before this call's first iteration: the actor has not
            # started yet
            with telemetry.sections("resample") if telemetry is not None \
                    else contextlib.nullcontext():
                self._resample()

        def is_resample(k: int) -> bool:
            return bool(every and (g0 + k + 1) % every == 0
                        and k != iterations - 1)

        self._is_resample = is_resample
        return self._run(
            exp, iterations, log_every, logger, ckpt, ckpt_every,
            eval_every, eval_fn, eval_logger, telemetry, is_resample,
            dict(config=exp.cfg.name, algo=exp.cfg.algo,
                 n_envs=exp.cfg.n_envs))

    def _barrier_work(self, k: int, sections, tracer) -> None:
        if self._is_resample(k):
            with sections("resample"), tracer.span("resample"):
                self._resample()


class AsyncPopulationRunner(_Engine):
    """The async engine over a :class:`.experiment.PopulationExperiment`:
    the actor rolls each member in turn with its own carry and its own
    copy of the member's policy, the learner runs
    ``parallel.population.make_member_learn_step`` for each member in
    turn, through the same queue, staleness gate and barriers as
    :class:`AsyncRunner`.

    **Exploit rounds** fire at drained-queue barriers predicted from the
    controller's window (both loops agree on the schedule up front, so
    the actor is parked and the weight copy is race-free); the run
    raises if the controller ever fires off that schedule. After a round
    the exploited weights are re-published under the same version, so
    the actor collects the next batch with them, as the sync loop does.

    **Bound 0** reproduces :meth:`.experiment.PopulationExperiment.run`
    bit for bit: every member's generators draw alone, in the sync
    loop's order, and the exploit schedule is the sync loop's.

    **Per-member staleness.** Every member of queue item ``i`` shares
    the item's lag; exploit resets the exploited members' last lag (they
    restart from just-published donor weights). ``async_info()`` reports
    the scalar aggregates and the per-member last/max vectors."""

    loop_name = "async-population"
    thread_name = "async-pop-actor"

    def __init__(self, pexp, groups: DeviceGroups | None = None,
                 staleness_bound: int = 1, queue_capacity: int = 2,
                 stall_timeout_s: float = 300.0):
        from .parallel.population import make_member_learn_step
        _check_bound(staleness_bound)
        cfg = pexp.cfg
        groups = _groups_for(pexp.device, groups)
        validate_rollout_geometry(cfg.ppo.n_steps, cfg.n_envs, 1)
        validate_update_geometry(cfg.ppo.n_epochs, cfg.ppo.n_minibatches,
                                 cfg.ppo.minibatch_size,
                                 n_steps=cfg.ppo.n_steps,
                                 n_envs=cfg.n_envs, n_devices=1)
        self.pexp = pexp
        self._n_steps = cfg.ppo.n_steps
        self._learn = make_member_learn_step(cfg.ppo)
        self._stale_last_pm = [0] * pexp.n_pop
        self._stale_max_pm = [0] * pexp.n_pop
        self._init_engine([m.net for m in pexp.members], groups,
                          staleness_bound, queue_capacity, stall_timeout_s)
        if not groups.shared:
            dev = groups.actor_device
            pexp.traces = _to(pexp.traces, dev)
            pexp.faults = _to(pexp.faults, dev)
            pexp.carries = [_move_carry(c, dev) for c in pexp.carries]

    def _hold_actor_state(self) -> None:
        p = self.pexp
        self._actor.hold(_tensors((p.traces, p.faults, p.carries)))

    def _learner_params(self) -> list:
        return [list(m.net.parameters()) for m in self.pexp.members]

    def _collect(self):
        p = self.pexp
        batch = []
        for m in range(p.n_pop):
            p.carries[m], tr, last_value = rollout(
                self._policies[m], p.env_params, p.traces, p.carries[m],
                self._n_steps, faults=p.faults[m] if p.faults else None)
            batch.append((tr, last_value))
        return batch

    def _update(self, batch):
        from .parallel.population import stack_members
        p = self.pexp
        per_member = []
        for m, (tr, last_value) in enumerate(batch):
            p.members[m], metrics = self._learn(
                p.members[m], tr, last_value, p.generators[m],
                p.member_hp[m])
            per_member.append(metrics)
        return stack_members(per_member)

    def _note_staleness(self, staleness: int) -> None:
        for m in range(self.pexp.n_pop):
            self._stale_last_pm[m] = staleness
            self._stale_max_pm[m] = max(self._stale_max_pm[m], staleness)

    def _after_update(self, k, g, i, metrics, sections, tracer,
                      telemetry) -> None:
        # PBT bookkeeping every iteration, as in the sync loop: record
        # leaves the fitness on the device, maybe_update fires only at
        # the predicted barriers; off schedule the actor is NOT parked,
        # so fail loudly rather than race the weight copy
        p, ctrl = self.pexp, self.pexp.controller
        ctrl.record(metrics.mean_reward)
        out = ctrl.maybe_update(g, p.members, p.hparams)
        if (out is not None) != self._is_exploit(k):
            raise RuntimeError(
                f"PBT exploit fired off the predicted barrier schedule at "
                f"iteration {g} (window={self._window}, ready_iters="
                f"{ctrl.cfg.ready_iters}): controller state was mutated "
                f"outside the runner")
        if out is None:
            return
        with sections("pbt"), tracer.span("pbt_exploit"):
            p.members, p.hparams, decision = out
            p._refresh_hparams()
            # the exploited weights under the SAME version: the parked
            # actor collects batch i+1 with them, as the sync loop does
            self._slot.publish(self._publish(), i + 1)
        for m, ex in enumerate(decision.exploited):
            if ex:
                self._stale_last_pm[m] = 0
        if telemetry is not None:
            telemetry.emit("pbt_exploit", iteration=g,
                           exploited=int(decision.exploited.sum()),
                           src=[int(s) for s in decision.src])

    def _row(self, metrics) -> dict:
        from .algos.ppo import PPOMetrics
        vals = torch.stack(list(metrics)).tolist()       # one read
        row = {}
        for name, v in zip(PPOMetrics._fields, vals):
            row.update({f"{name}_{m}": x for m, x in enumerate(v)})
            row[f"{name}_mean"] = sum(v) / len(v)
        return row

    def _rho(self, row: dict):
        return (row["rho_mean_mean"],
                max(row[f"rho_max_{m}"] for m in range(self.pexp.n_pop)))

    def _summary(self) -> dict:
        ctrl = self.pexp.controller
        return {"final_fitness": [float(f) for f in ctrl.mean_fitness],
                "pbt_events": len(ctrl.history)}

    def _end_info(self) -> dict:
        return {"pbt_events": len(self.pexp.controller.history)}

    def run(self, iterations: int | None = None, log_every: int = 0,
            logger: Callable[[int, dict], None] | None = None,
            ckpt=None, ckpt_every: int = 0,
            eval_every: int = 0,
            eval_fn: "Callable[[int], dict] | None" = None,
            eval_logger: Callable[[int, dict], None] | None = None,
            telemetry=None) -> dict:
        """Run ``iterations`` overlapped population iterations; the hook
        surface mirrors :meth:`.experiment.PopulationExperiment.run`
        minus watchdog/injector. PBT exploit/explore and checkpoints run
        at drained-queue barriers."""
        pexp = self.pexp
        ctrl = pexp.controller
        iterations = iterations or pexp.cfg.iterations
        # predict the controller's exploit iterations so both loops agree
        # on the barrier set up front: maybe_update consults only its
        # recorded-window count (never the iteration number) and resets
        # the window on fire, so with `window` records carried in from
        # earlier calls (or a restore), local iteration k fires exactly
        # when (window + k + 1) % ready_iters == 0
        self._window = window = ctrl._fitness_n + len(ctrl._pending)
        ready = ctrl.cfg.ready_iters

        def is_exploit(k: int) -> bool:
            return (window + k + 1) % ready == 0

        self._is_exploit = is_exploit
        return self._run(
            pexp, iterations, log_every, logger, ckpt, ckpt_every,
            eval_every, eval_fn, eval_logger, telemetry, is_exploit,
            dict(config=pexp.cfg.name, n_pop=pexp.n_pop,
                 n_envs=pexp.cfg.n_envs))

    def async_info(self) -> dict:
        """Overlap/staleness accounting, with the per-member lag vectors
        (uniform per stacked batch; exploit resets the exploited
        members' last lag)."""
        info = super().async_info()
        rho = {k: info.pop(k) for k in ("importance_ratio_mean",
                                        "importance_ratio_max")}
        return {**info,
                "staleness_last_per_member": list(self._stale_last_pm),
                "staleness_max_per_member": list(self._stale_max_pm),
                **rho}
