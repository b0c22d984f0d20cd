"""Continuous batching (L6) of the port: queue -> coalesce -> pad ->
scatter, in front of one :class:`~.engine.InferenceEngine`.

Counterpart of the JAX package's ``serve/batching.py`` (pure numpy and
threads: it ports as it stands, the flywheel's flight-log tap included;
its ``jax.tree`` calls are :mod:`..tree`'s). Many independent decision
streams become ONE dispatch when their observations are stacked along a batch axis:

- **coalesce**: pending requests are drained FIFO and rounded up to the
  next power-of-two *bucket* (:func:`next_bucket`), so the engine builds
  one program (one CUDA graph on the card) per bucket, not per request
  count;
- **pad**: the tail of the bucket is filled with neutral rows (zero
  observations, all-actions-legal masks: a padded row must never
  produce ``-inf``-everywhere logits; its action is discarded anyway);
- **scatter**: the batched actions are split back to the submitting
  requests in FIFO order.

The hot path is the **arena data plane** (``data_plane="arena"``, the
default): requests land directly in preallocated bucket-sized slabs
(one memcpy into the slot row -- ``submit`` IS the stack), ``pump``
seals a slab in place and dispatches a contiguous view of its live rows
(the engine pads them to the bucket in its own staging buffers), and
the scatter hands back the actions of the engine's download buffer.
JAX's server dispatches the whole padded bucket instead, so its router
counts padding rows as served rows; the port's router sees, and counts,
only the live ones. Steady state allocates no host ndarray
per batch (``serve_arena_allocs_total`` counts slab allocations and
must stay flat after warmup). Producers take one O(1) critical section
to reserve a slot; the row memcpy and the publish flag happen outside
any lock, and the consumer never holds the producers' lock during its
O(batch) work. The pre-arena plane survives as ``data_plane="legacy"``
(stack per batch, the engine pads): the "before" arm of
:func:`.bench.run_host_path`.

A request is one ``obs`` row and one ``mask`` row, host numpy, no
leading axis: single arrays for the flat, grid and graph observations,
dicts of arrays for the hierarchical env (``{"top", "pods"}``). The
arena keeps one slab per leaf; device placement is the engine's job.
Several dispatchers (:meth:`PolicyServer.start`) keep that many
dispatches in flight over a multi-engine router
(:class:`.router.EngineRouter`).

**Admission after a stall.** Admission sheds a deadlined request when
the queued dispatches ahead of it, times the learned service time,
exceed its deadline; the estimate learns only from finished
dispatches. JAX's server stays locked once one stretched dispatch (a
long garbage collection) lifts the estimate above the deadline: every
later request is shed, no dispatch runs, and the estimate never falls.
Here a request that would be shed, but finds the queue empty, no
dispatch in flight and the last dispatch ended more than one estimate
ago, is admitted as a *probe*, and the dispatch that serves it
replaces the estimate with its own time, so one probe relearns it.
Where the estimate is fresh (a dispatch ended less than one estimate
ago) the server sheds as JAX's does. Besides, one dispatch counts at
most :data:`SAMPLE_CAP` times the estimate it updates: a lone pause
(a full collection holds every thread) then cannot shed the burst of
requests it held back, while a lasting slowdown is still learned,
by a factor of up to 1.6 a dispatch.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import random
import threading
import time
from concurrent.futures import Future

import numpy as np

from ..obs.metrics import Registry
from ..obs.slo import SLOEngine, SLOSpec, histogram_sli
from ..obs.trace import NULL_TRACER
from ..tree import leaves, stack, structure, tree_map, unflatten


class Reservoir:
    """Bounded uniform sample of an unbounded stream (Vitter's
    Algorithm R): the first ``capacity`` observations are kept verbatim,
    after which each new observation replaces a random kept one with
    probability ``capacity / count``. Memory stays flat while every
    observation ever made has EQUAL probability of being in the sample,
    so a soak's percentiles describe the whole run. Seeded so two
    servers replaying one workload keep identical samples.

    Sequence protocol (``len``/indexing/iteration) so ``np.asarray`` and
    ``np.percentile`` consume it directly; ``count`` is the total number
    of observations ever offered."""

    def __init__(self, capacity: int, seed: int = 0):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.count = 0
        self._rng = random.Random(seed)
        self._samples: list[float] = []

    def append(self, v: float) -> None:
        self.count += 1
        if len(self._samples) < self.capacity:
            self._samples.append(v)
            return
        j = self._rng.randrange(self.count)
        if j < self.capacity:
            self._samples[j] = v

    def __len__(self) -> int:
        return len(self._samples)

    def __getitem__(self, i):
        return self._samples[i]

    def __iter__(self):
        return iter(self._samples)


def next_bucket(n: int, max_bucket: int) -> int:
    """The power-of-two batch bucket for ``n`` requests (smallest power
    of two >= n, capped by ``max_bucket``)."""
    if n <= 0:
        raise ValueError(f"need at least one request, got {n}")
    if max_bucket <= 0 or (max_bucket & (max_bucket - 1)):
        raise ValueError(f"max_bucket must be a positive power of two, "
                         f"got {max_bucket}")
    if n > max_bucket:
        raise ValueError(f"{n} requests exceed max_bucket={max_bucket}; "
                         f"drain in max_bucket-sized dispatches")
    return 1 << (n - 1).bit_length()


def pad_batch(batch, bucket: int, fill_mask_true: bool = False):
    """Pad a host batch (an array or a tree of arrays, leading axis n)
    from n rows up to ``bucket`` rows, leaf by leaf.

    Padding rows are zeros, except boolean leaves with
    ``fill_mask_true``: action masks pad with every action legal, so the
    padding rows' logits stay finite. A full bucket is returned as is."""
    def pad(x):
        x = np.asarray(x)
        n = x.shape[0]
        if n > bucket:
            raise ValueError(f"batch of {n} rows exceeds bucket {bucket}")
        if n == bucket:
            return x
        value = True if (fill_mask_true and x.dtype == np.bool_) else 0
        return np.concatenate([x, np.full((bucket - n,) + x.shape[1:],
                                          value, x.dtype)])

    return tree_map(pad, batch)


def stack_requests(rows: list):
    """Stack per-request rows (arrays or trees of arrays, no leading
    axis) into one batch, leaf by leaf (leading axis = len(rows), FIFO
    order kept). The legacy plane's stack, and the router's probe
    batch; the arena plane never stacks."""
    return stack(rows)


def scatter_results(actions, n: int) -> list:
    """Split batched actions (an array, or a dict of per-head arrays)
    back into ``n`` per-request values in submission order, dropping
    the padding tail."""
    return [tree_map(lambda x: np.asarray(x)[i], actions)
            for i in range(n)]


@dataclasses.dataclass
class ServeResult:
    """What a request's future resolves to."""
    action: object         # the request's action (numpy, or a dict of heads)
    latency_s: float       # submit -> result, queue wait included
    req_id: int = 0        # request-causality id; 0 = unassigned


class DeadlineSheddedError(RuntimeError):
    """Typed rejection a shed request's future resolves with.

    Shedding is never a silent drop: the future completes exceptionally
    with this error, carrying why (``reason``: ``"admission"`` -- the
    predicted wait at submit already exceeded the deadline -- or
    ``"expired"`` -- the deadline passed while queued) and the numbers
    behind the verdict, so a client can retry elsewhere, relax its
    deadline, or back off."""

    def __init__(self, reason: str, deadline_s: float, waited_s: float,
                 predicted_wait_s: "float | None" = None, req_id: int = 0):
        self.reason = reason
        self.deadline_s = float(deadline_s)
        self.waited_s = float(waited_s)
        self.predicted_wait_s = predicted_wait_s
        self.req_id = int(req_id)
        pred = (f", predicted wait {predicted_wait_s * 1e3:.1f}ms"
                if predicted_wait_s is not None else "")
        super().__init__(
            f"request shed ({reason}): deadline {deadline_s * 1e3:.1f}ms"
            f", waited {waited_s * 1e3:.1f}ms{pred}")


class ServerClosedError(RuntimeError):
    """Typed refusal for submits against a stopped or closed server:
    raised by :meth:`PolicyServer.submit` while a :meth:`PolicyServer.stop`
    drain is in flight and forever after :meth:`PolicyServer.close`, so
    a client racing a shutdown gets a catchable refusal instead of a
    future no dispatcher will ever resolve."""


class Ewma:
    """Streaming exponentially-weighted mean: the arrival-gap and
    service-time estimator behind adaptive batching and admission.
    ``alpha`` is the forgetting factor; ``value`` is ``None`` until the
    first observation (callers must not act on an unlearned estimate)."""

    def __init__(self, alpha: float = 0.2):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.value: "float | None" = None
        self.count = 0

    def update(self, x: float) -> float:
        x = float(x)
        self.count += 1
        self.value = (x if self.value is None
                      else self.alpha * x + (1 - self.alpha) * self.value)
        return self.value

    def reset(self) -> None:
        """Forget the estimate (back to ``value is None``): the world it
        described is gone, e.g. a router's fleet changed."""
        self.value = None
        self.count = 0


@dataclasses.dataclass
class _Pending:
    obs: object            # a request row: an array or a tree of arrays
    mask: object
    stall: int
    t_submit: float
    future: Future
    deadline_s: "float | None" = None   # relative to t_submit; None = no SLO
    req_id: int = 0


class _SlotRef:
    """Read-only view of one pending arena slot for estimator scans
    (duck-typed like :class:`_Pending`: ``t_submit`` and
    ``deadline_s``)."""
    __slots__ = ("t_submit", "deadline_s")

    def __init__(self, t_submit: float, deadline_s: "float | None"):
        self.t_submit = t_submit
        self.deadline_s = deadline_s


class _ArenaBlock:
    """One bucket-sized slab of the request ring: one preallocated array
    per obs and mask leaf (leading axis = ``capacity`` slots), the stall
    and request-id lanes, and per-slot metadata lists. Slots are claimed in
    order (``claimed`` is the reservation high-water mark);
    ``published[i]`` flips True (a GIL-atomic list store, no lock) only
    after slot ``i``'s row and metadata are written, so a consumer never
    reads a torn row."""

    __slots__ = ("obs", "mask", "stall", "req", "futures", "t_submit",
                 "deadline", "published", "dead", "claimed", "n_dead",
                 "n_deadlined")

    def __init__(self, obs_leaves: "list[np.ndarray]",
                 mask_leaves: "list[np.ndarray]", capacity: int):
        self.obs = [np.zeros((capacity,) + x.shape, x.dtype)
                    for x in obs_leaves]
        self.mask = [np.zeros((capacity,) + x.shape, x.dtype)
                     for x in mask_leaves]
        self.stall = np.zeros(capacity, np.int32)
        self.req = np.zeros(capacity, np.int64)
        self.futures: "list[Future | None]" = [None] * capacity
        self.t_submit = [0.0] * capacity
        self.deadline: "list[float | None]" = [None] * capacity
        self.published = [False] * capacity
        self.dead = [False] * capacity
        self.claimed = 0
        self.n_dead = 0
        self.n_deadlined = 0

    def reset(self) -> None:
        """Return the block to the empty state for recycling. Slab rows
        are not zeroed: a dispatch reads only the live rows the seal
        compacted, so stale rows are never read."""
        for i in range(self.claimed):
            self.futures[i] = None
            self.deadline[i] = None
            self.published[i] = False
            self.dead[i] = False
        self.claimed = 0
        self.n_dead = 0
        self.n_deadlined = 0


class _ArenaRing:
    """Fixed-capacity multi-producer ring of :class:`_ArenaBlock` slabs.

    Producers reserve a slot under ``lock`` (an O(1) critical section:
    a sequence bump, on block rollover one deque rotation), then write
    the row and publish outside it. The consumer takes whole blocks
    (FIFO: sealed blocks first, else it force-seals the current one) and
    recycles them after the scatter; a full ring back-pressures
    producers on ``cond`` until a block frees (bounded memory)."""

    def __init__(self, obs_leaves: "list[np.ndarray]",
                 mask_leaves: "list[np.ndarray]", bucket: int,
                 n_blocks: int, alloc_counter=None):
        self.bucket = int(bucket)
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self._obs_leaves = obs_leaves
        self._mask_leaves = mask_leaves
        self._alloc_counter = alloc_counter
        self.n_blocks = 0
        self.depth = 0              # live (not shed) slots not yet taken
        self.sealed: "collections.deque[_ArenaBlock]" = collections.deque()
        self.free: "collections.deque[_ArenaBlock]" = collections.deque()
        self.cur = self._new_block()
        for _ in range(max(2, n_blocks) - 1):
            self.free.append(self._new_block())

    def _new_block(self) -> _ArenaBlock:
        blk = _ArenaBlock(self._obs_leaves, self._mask_leaves, self.bucket)
        self.n_blocks += 1
        if self._alloc_counter is not None:
            # one slab per obs and mask leaf, the stall and req-id lanes
            self._alloc_counter.inc(
                len(self._obs_leaves) + len(self._mask_leaves) + 2)
        return blk

    def grow(self, n_blocks: int) -> None:
        """Ensure at least ``n_blocks`` blocks exist (construction and
        :meth:`PolicyServer.start` only, never on the steady-state
        path)."""
        with self.lock:
            while self.n_blocks < n_blocks:
                self.free.append(self._new_block())
            self.cond.notify_all()

    def blocks(self) -> "list[_ArenaBlock]":
        """Ring-resident blocks in FIFO order (caller holds ``lock``)."""
        return [*self.sealed, self.cur]

    def take_block(self) -> "_ArenaBlock | None":
        """Remove and return the oldest block with claimed slots (the
        current block is force-sealed when nothing older waits), or None
        when the ring is empty. A taken block is invisible to producers
        and shed scans until :meth:`recycle`."""
        with self.lock:
            if self.sealed:
                blk = self.sealed.popleft()
            elif self.cur.claimed > 0 and self.free:
                blk = self.cur
                self.cur = self.free.popleft()
            else:
                return None
            self.depth -= blk.claimed - blk.n_dead
            return blk

    def recycle(self, blk: _ArenaBlock) -> None:
        blk.reset()
        with self.lock:
            self.free.append(blk)
            self.cond.notify_all()

    def head_t_submit(self) -> "float | None":
        """Submit time of the oldest live published slot (the static
        hold-wait anchor). A racy read: a concurrent take makes the
        anchor momentarily stale, which only shortens a hold."""
        blk = self.sealed[0] if self.sealed else self.cur
        for i in range(blk.claimed):
            if blk.published[i] and not blk.dead[i]:
                return blk.t_submit[i]
        return None

    def pending_slots(self) -> "list[_SlotRef]":
        """Snapshot of live pending slots for estimator scans."""
        out: list[_SlotRef] = []
        with self.lock:
            for blk in self.blocks():
                for i in range(blk.claimed):
                    if blk.published[i] and not blk.dead[i]:
                        out.append(_SlotRef(blk.t_submit[i],
                                            blk.deadline[i]))
        return out


class _RingPending:
    """The legacy pending deque's surface over the arena ring, so the
    shared estimator code sees one interface: ``len()``/truthiness is
    the live pending depth, iteration yields :class:`_SlotRef`
    snapshots."""

    def __init__(self, server: "PolicyServer"):
        self._server = server

    def __len__(self) -> int:
        ring = self._server._ring
        return ring.depth if ring is not None else 0

    def __bool__(self) -> bool:
        return len(self) > 0

    def __iter__(self):
        ring = self._server._ring
        return iter(ring.pending_slots() if ring is not None else ())


_DATA_PLANES = ("arena", "legacy")
# capacity of the latency, occupancy and exemplar reservoirs
LATENCY_WINDOW = 8192
# one dispatch's time enters the service-time estimate capped at this
# multiple of the estimate (the first, and a probe's, enter whole)
SAMPLE_CAP = 4.0


class PolicyServer:
    """The continuous-batching request queue over one engine (an
    :class:`~.engine.InferenceEngine`, a :class:`~.router.EngineRouter`,
    or anything with their ``max_bucket``/``bucket_for``/``decide``).

    ``submit`` enqueues a request and returns a
    :class:`concurrent.futures.Future` resolving to :class:`ServeResult`;
    ``pump`` drains up to ``engine.max_bucket`` pending requests into one
    coalesced dispatch. Drive it inline (submit-then-pump: deterministic
    batch composition, what ``serve --bench`` does) or through the
    background dispatcher threads (:meth:`start` / :meth:`stop`) for live
    continuous batching.

    **Data planes.** ``data_plane="arena"`` (default) is the zero-copy
    hot path; slabs are sized from ``example_obs``/``example_mask`` when
    given, else from the first submitted request (row shapes and dtypes
    are then fixed: later submits must match, and float rows are cast to
    the arena dtype). ``data_plane="legacy"`` keeps the stack/pad path.

    **Deadlines.** ``submit(deadline_s=)`` subjects a request to load
    shedding: the future resolves with :class:`DeadlineSheddedError`
    when the predicted wait at submit (queued dispatches ahead x learned
    service time) exceeds the deadline, or when the deadline passes in
    the queue; after a stall a lone request is admitted as a probe (the
    module docstring). ``max_wait_s`` holds a partial bucket until it
    fills or the wait passes; ``adaptive_wait`` learns the hold from the
    arrival-gap and service-time :class:`Ewma` s. When the engine has
    ``add_rewarm_listener`` (the router has), a fleet change resets the
    learned service time.

    **SLO surface** (the ``registry``): ``serve_requests_total``,
    ``serve_shed_total``, ``serve_dispatches_total``,
    ``serve_padded_slots_total``, ``serve_queue_depth``,
    ``serve_batch_occupancy``, the ``serve_decision_latency_seconds``
    and ``serve_queue_wait_seconds`` histograms,
    ``serve_latency_sample_window``, ``serve_dispatch_errors_total``,
    ``serve_arena_allocs_total``, and the p50/p99 and decisions/s gauges
    of :meth:`slo_snapshot`, refreshed by a registry collector hook at
    every render. ``self.slo`` is an :class:`~..obs.slo.SLOEngine`
    watching availability, queue latency and engine health.

    **Request ids**: every submit carries a 64-bit ``req_id`` (given or
    minted here: ``[0][7 rank][16 pid][40 seq]``) that rides an int64
    lane of the arena slab and comes back on the :class:`ServeResult`
    and the tracer's instants.

    With a ``tracer`` the request lifecycle lands on the bus: an
    ``enqueue`` instant per submit, then ``bucket_wait`` ->
    ``serve_batch`` (``arena_seal`` or ``stack`` -> the engine's
    ``pad``/``dispatch`` -> ``scatter``) per pump.

    **Flight log** (the flywheel's tap): with ``flight_log=`` (a
    :class:`..flywheel.FlightLogWriter`) over a capture-mode engine
    (``capture=True``: ``decide`` returns ``(actions, log_prob,
    value)``), every served row is appended after its dispatch with its
    deadline outcome (0 no deadline, 1 met, 2 late) and request id. Shed
    rows never dispatch, so ``rows_logged`` equals the served count. The
    append runs on the dispatcher thread and touches only numpy and
    files (the sync guard allows it); a failing append fails its batch's
    futures. A writer over a plain engine raises ``ValueError``.
    """

    def __init__(self, engine, registry: "Registry | None" = None,
                 clock=time.perf_counter,
                 max_wait_s: "float | None" = None, tracer=None,
                 adaptive_wait: bool = False, data_plane: str = "arena",
                 example_obs=None, example_mask=None,
                 flight_log=None, bus=None):
        # the flywheel's tap: a capture-mode engine returns (actions,
        # behavior log-prob, value) per dispatch
        self._capture = bool(getattr(engine, "capture", False))
        self._flight_log = flight_log
        if flight_log is not None and not self._capture:
            raise ValueError(
                "flight_log requires a capture-mode engine "
                "(capture=True): the log's behavior log-prob and value "
                "columns come out of the engine's decision graph, never "
                "a post-hoc recompute")
        self.engine = engine
        self.registry = registry if registry is not None else Registry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.bus = bus
        # request ids: 64 bits = [1 zero bit][7 rank][16 pid][40 seq],
        # disjoint across ranks and processes without coordination, the
        # sign bit clear; seq starts at 1, id 0 means "unassigned"
        rank = int(getattr(bus, "rank", 0) or 0)
        self._req_salt = (((rank & 0x7F) << 56)
                          | ((os.getpid() & 0xFFFF) << 40))
        self._req_seq = itertools.count(1)
        if max_wait_s is not None and max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        if data_plane not in _DATA_PLANES:
            raise ValueError(f"data_plane must be one of {_DATA_PLANES}, "
                             f"got {data_plane!r}")
        self.max_wait_s = max_wait_s
        self.adaptive_wait = bool(adaptive_wait)
        self.data_plane = data_plane
        self._clock = clock
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._sleepers = 0          # consumers parked on _wake (under _lock)
        self._shed_lock = threading.Lock()   # serializes shed counting
        self._pending = (collections.deque() if data_plane == "legacy"
                         else _RingPending(self))
        self._ring: "_ArenaRing | None" = None
        # at least 4 blocks: an in-flight dispatcher can hold one while
        # another is current and one stays free, so the ring never
        # wedges; start(dispatchers=N) raises the floor to N + 2
        self._min_blocks = max(4, min(128, 1024 // int(engine.max_bucket)))
        # lifetime-uniform reservoirs: a soak's p99 describes the whole
        # run, not its trailing window
        self._latencies = Reservoir(LATENCY_WINDOW, seed=0)
        self._occupancies = Reservoir(LATENCY_WINDOW, seed=1)
        # exemplar lane: same capacity and seed as _latencies, appended
        # in lockstep, so sample i's request id is _latency_req_ids[i]
        self._latency_req_ids = Reservoir(LATENCY_WINDOW, seed=0)
        self._threads: list[threading.Thread] = []
        self._stopped = False
        self._closed = False
        self._served = 0
        self._t_first: "float | None" = None
        self._t_last: "float | None" = None
        self._arrival_gap = Ewma(alpha=0.2)
        self._service_time = Ewma(alpha=0.2)
        self._t_prev_submit: "float | None" = None
        # dispatches taken and not yet finished, and when the last one
        # finished: the probe rule of _admission reads both
        self._inflight = 0
        self._t_dispatch_end: "float | None" = None
        self._relearn = False       # a probe was admitted
        self._requests = self.registry.counter(
            "serve_requests_total", "scheduling requests submitted")
        self._shed = self.registry.counter(
            "serve_shed_total",
            "requests rejected with a typed deadline rejection "
            "(admission + in-queue expiry)")
        self._dispatches = self.registry.counter(
            "serve_dispatches_total", "coalesced batch dispatches")
        self._padded = self.registry.counter(
            "serve_padded_slots_total",
            "bucket slots filled with padding instead of requests")
        self._depth = self.registry.gauge(
            "serve_queue_depth", "requests waiting after the last drain")
        self._occupancy = self.registry.gauge(
            "serve_batch_occupancy",
            "real rows / bucket rows of the last dispatch")
        self._sample_window = self.registry.gauge(
            "serve_latency_sample_window",
            "latency samples currently held by the reservoir")
        self._latency_hist = self.registry.histogram(
            "serve_decision_latency_seconds",
            "submit->result decision latency (cumulative histogram; "
            "aggregatable across ranks/restarts, unlike percentile "
            "gauges)")
        self._queue_wait_hist = self.registry.histogram(
            "serve_queue_wait_seconds",
            "submit->dispatch queue wait (the shed-or-scale half of "
            "decision latency: service time is the other half, and "
            "only the split says which knob to turn)")
        self._dispatch_errors = self.registry.counter(
            "serve_dispatch_errors_total",
            "background pumps that raised after resolving their batch's "
            "futures exceptionally (the dispatcher survives and keeps "
            "serving)")
        self._arena_allocs = self.registry.counter(
            "serve_arena_allocs_total",
            "host ndarrays allocated by the arena data plane (slab "
            "construction; steady state must stay flat)")
        if (example_obs is None) != (example_mask is None):
            raise ValueError("example_obs and example_mask must be given "
                             "together (the arena is sized from both)")
        if example_obs is not None and data_plane == "arena":
            self.ensure_arena(example_obs, example_mask)
        add_listener = getattr(engine, "add_rewarm_listener", None)
        if callable(add_listener):
            add_listener(self._on_engine_rewarm)
        # the hedge counter is the router's, shared through the registry
        # (registering it again returns the same series); over one
        # engine it never moves, but the engine-health SLI reads it
        self._hedges = self.registry.counter(
            "serve_retry_hedges_total",
            "dispatches retried on a sibling engine after a failure")
        # burn rates re-evaluated by the registry's collector hook;
        # soak-scale windows, since the process's serving life is the soak
        self.slo = SLOEngine(self.registry, bus=bus)
        self.slo.watch(SLOSpec(
            "availability", objective=0.99,
            windows=((5.0, 2.0), (30.0, 1.0)), budget_window_s=30.0,
            description="fraction of admitted requests neither shed "
                        "nor failed"), self._availability_sli)
        self.slo.watch(SLOSpec(
            "queue-latency", objective=0.95,
            windows=((5.0, 2.0), (30.0, 1.0)), budget_window_s=30.0,
            description="fraction of requests dispatched within 250ms "
                        "of submit"),
            histogram_sli(self._queue_wait_hist, 0.25))
        self.slo.watch(SLOSpec(
            "engine-health", objective=0.999,
            windows=((1.0, 1.0), (3.0, 1.0)), budget_window_s=3.0,
            description="fraction of dispatches served without a "
                        "hedge or failure"), self._engine_health_sli)
        self.registry.add_collector(self._refresh_slo_gauges)

    # ---- estimator lifecycle -----------------------------------------

    def _on_engine_rewarm(self) -> None:
        """The router's fleet changed (a spin-up warm, an active-count
        change, a weight swap): the learned per-dispatch service time
        described the old fleet, so forget it (admission admits until it
        relearns)."""
        with self._lock:
            self._service_time.reset()

    # ---- request ids -------------------------------------------------

    def mint_request_id(self) -> int:
        """Next request id. ``itertools.count.__next__`` is atomic under
        the GIL, and the rank/pid salt keeps processes disjoint."""
        return self._req_salt | (next(self._req_seq) & 0xFFFFFFFFFF)

    # ---- SLIs --------------------------------------------------------

    def _availability_sli(self) -> "tuple[float, float]":
        """(bad, total): typed sheds plus failed dispatches over the
        requests admitted at the door."""
        return (self._shed.value + self._dispatch_errors.value,
                self._requests.value)

    def _engine_health_sli(self) -> "tuple[float, float]":
        """(bad, total): hedges plus failed dispatches over dispatches
        attempted."""
        return (self._hedges.value + self._dispatch_errors.value,
                self._dispatches.value + self._dispatch_errors.value)

    def _refresh_slo_gauges(self) -> None:
        """Collector hook: the percentile and throughput gauges are
        recomputed at every render."""
        self.slo_snapshot()

    # ---- arena construction ------------------------------------------

    def ensure_arena(self, example_obs, example_mask) -> None:
        """Build the slab ring from one example request row (no leading
        axis; an array or a tree of arrays); from the constructor when
        examples are given, else by the first :meth:`submit`.
        Idempotent; the row structure, shapes and dtypes are fixed from
        the example."""
        if self.data_plane != "arena" or self._ring is not None:
            return
        with self._lock:
            if self._ring is not None:
                return
            obs_leaves = [np.asarray(x) for x in leaves(example_obs)]
            mask_leaves = [np.asarray(x) for x in leaves(example_mask)]
            self._obs_like = example_obs
            self._mask_like = example_mask
            self._obs_is_leaf = isinstance(example_obs, np.ndarray)
            self._mask_is_leaf = isinstance(example_mask, np.ndarray)
            self._obs_structure = structure(example_obs)
            self._mask_structure = structure(example_mask)
            self._obs_row_shapes = [x.shape for x in obs_leaves]
            self._mask_row_shapes = [x.shape for x in mask_leaves]
            self._ring = _ArenaRing(
                obs_leaves, mask_leaves, int(self.engine.max_bucket),
                self._min_blocks, alloc_counter=self._arena_allocs)

    def arena_stats(self) -> dict:
        """Arena occupancy and allocation surface for benches."""
        ring = self._ring
        return {
            "data_plane": self.data_plane,
            "blocks": ring.n_blocks if ring is not None else 0,
            "rows": (ring.n_blocks * ring.bucket
                     if ring is not None else 0),
            "slab_allocs": int(self._arena_allocs.value),
        }

    # ---- shedding ----------------------------------------------------

    def _reject(self, fut: Future, exc: DeadlineSheddedError,
                reason: str) -> None:
        """Resolve ``fut`` with a typed shed rejection and count it,
        counting only when this call won the future's transition (a
        request raced by two expiry scans, or cancelled, counts at most
        once), so submitted == resolved + shed holds by construction."""
        try:
            fut.set_exception(exc)
        except BaseException:   # cancelled, or already resolved elsewhere
            return
        with self._shed_lock:
            self._shed.inc()
        self.tracer.instant("shed", reason=reason, req_id=exc.req_id)

    # ---- submit ------------------------------------------------------

    def submit(self, obs: np.ndarray, mask: np.ndarray, stall: int = 0,
               deadline_s: "float | None" = None,
               req_id: "int | None" = None) -> Future:
        """Enqueue one scheduling request (host rows, NO leading batch
        axis). ``stall`` is the client's consecutive-zero-dt count for
        the stall gate (preemptive configs; 0 = gate disengaged);
        ``req_id`` the request id (minted when None or 0);
        ``deadline_s`` the request's latency SLO relative to submit,
        which subjects it to shedding (admission sheds only once the
        service-time estimator has learned: a cold server admits
        everything). On the arena plane this call is the one host copy
        of the request: the row lands in its slab slot, and a row whose
        shape does not match the arena raises ``ValueError`` here."""
        req_id = self.mint_request_id() if not req_id else int(req_id)
        if self.data_plane == "legacy":
            return self._submit_legacy(obs, mask, stall, deadline_s,
                                       req_id)
        return self._submit_arena(obs, mask, stall, deadline_s, req_id)

    def _refuse_if_closed(self) -> None:
        if self._closed:
            raise ServerClosedError(
                "PolicyServer is closed (drained for shutdown)")
        if self._stopped:
            raise ServerClosedError(
                "PolicyServer is stopped (drain in flight)")

    def _admission(self, now: float, depth: int,
                   deadline_s: "float | None", req_id: int,
                   ) -> "DeadlineSheddedError | None":
        """Count the request and learn its arrival gap; the typed
        rejection if its predicted wait already exceeds its deadline
        (caller holds the producers' lock)."""
        self._requests.inc()
        if self._t_prev_submit is not None:
            self._arrival_gap.update(now - self._t_prev_submit)
        self._t_prev_submit = now
        svc = self._service_time.value
        if deadline_s is None or svc is None:
            return None
        # dispatches ahead of this request if it joins the queue, itself
        # included; each costs about one learned service time
        ahead = -(-(depth + 1) // self.engine.max_bucket)
        predicted = ahead * svc
        if predicted <= deadline_s:
            return None
        if (depth == 0 and self._inflight == 0
                and self._t_dispatch_end is not None
                and now - self._t_dispatch_end > svc):
            # a probe: nothing queued or in flight, and the estimate is
            # older than itself; only a dispatch can relearn it
            self._relearn = True
            return None
        return DeadlineSheddedError("admission", deadline_s, waited_s=0.0,
                                    predicted_wait_s=predicted,
                                    req_id=req_id)

    def _submit_legacy(self, obs, mask, stall, deadline_s,
                       req_id) -> Future:
        now = self._clock()
        fut: Future = Future()
        deadline_s = None if deadline_s is None else float(deadline_s)
        with self._wake:
            self._refuse_if_closed()
            shed = self._admission(now, len(self._pending), deadline_s,
                                   req_id)
            if shed is not None:
                self._reject(fut, shed, reason="admission")
                return fut
            self._pending.append(_Pending(
                obs=obs, mask=mask, stall=int(stall), t_submit=now,
                future=fut, deadline_s=deadline_s, req_id=req_id))
            self._wake.notify()
        self.tracer.instant("enqueue", stall=int(stall), req_id=req_id)
        return fut

    def _write_row(self, blk: _ArenaBlock, i: int, obs, mask,
                   stall: int) -> None:
        """The one memcpy per leaf: request row -> slab slot ``i``. A
        structure or shape mismatch raises before any slab write (no
        torn rows)."""
        rows = []
        for what, row, want, shapes in (
                ("obs", obs, self._obs_structure, self._obs_row_shapes),
                ("mask", mask, self._mask_structure,
                 self._mask_row_shapes)):
            if structure(row) != want:
                raise ValueError(f"{what} row is not structured as the "
                                 f"arena's ({want})")
            row_leaves = leaves(row)
            for j, leaf in enumerate(row_leaves):
                if np.shape(leaf) != shapes[j]:
                    raise ValueError(
                        f"{what} row has shape {np.shape(leaf)}, arena "
                        f"row is {shapes[j]}" + (f" (leaf {j})"
                                                 if len(shapes) > 1 else ""))
            rows.append(row_leaves)
        for dst, src in zip(blk.obs + blk.mask, rows[0] + rows[1]):
            dst[i] = src
        blk.stall[i] = stall

    def _submit_arena(self, obs, mask, stall, deadline_s,
                      req_id) -> Future:
        if self._ring is None:
            self.ensure_arena(obs, mask)     # lazy sizing, first request
        ring = self._ring
        now = self._clock()
        fut: Future = Future()
        deadline_s = None if deadline_s is None else float(deadline_s)
        with ring.lock:
            self._refuse_if_closed()
            shed = self._admission(now, ring.depth, deadline_s, req_id)
            if shed is None:
                # common case inlined: the current block has a free slot
                blk = ring.cur
                i = blk.claimed
                if i < ring.bucket:
                    blk.claimed = i + 1
                    ring.depth += 1
                else:
                    blk, i = self._reserve_slot_locked(ring)
        if shed is not None:
            self._reject(fut, shed, reason="admission")
            return fut
        # outside every lock: the row copy and the publish store
        try:
            # one-array rows inlined: the per-request hot path the host
            # bench measures, where the tree walk costs more than the copy
            if (self._obs_is_leaf and self._mask_is_leaf
                    and type(obs) is np.ndarray and type(mask) is np.ndarray
                    and obs.shape == self._obs_row_shapes[0]
                    and mask.shape == self._mask_row_shapes[0]):
                blk.obs[0][i] = obs
                blk.mask[0][i] = mask
                blk.stall[i] = stall
            else:
                self._write_row(blk, i, obs, mask, int(stall))
        except BaseException:
            # the slot is reserved: kill it in place (the error goes to
            # the caller; there is no future holder to strand)
            with ring.lock:
                blk.dead[i] = True
                blk.n_dead += 1
                ring.depth -= 1
            blk.published[i] = True
            raise
        blk.req[i] = req_id
        blk.t_submit[i] = now
        blk.deadline[i] = deadline_s
        blk.futures[i] = fut
        if deadline_s is not None:
            blk.n_deadlined += 1
        blk.published[i] = True      # GIL-atomic store: slot now visible
        if self._sleepers:           # wake a parked consumer
            with self._wake:
                self._wake.notify_all()
        if self.tracer is not NULL_TRACER:
            self.tracer.instant("enqueue", stall=int(stall),
                                req_id=req_id)
        return fut

    def _reserve_slot_locked(self, ring: _ArenaRing):
        """Claim the next slot (caller holds ``ring.lock``), rolling the
        current block over when full; a full ring waits for the consumer
        to recycle a block, in bounded slices so a close() during the
        wait raises instead of hanging."""
        while True:
            blk = ring.cur
            i = blk.claimed
            if i < ring.bucket:
                blk.claimed = i + 1
                ring.depth += 1
                return blk, i
            if ring.free:               # rollover: seal, swap in a free
                ring.sealed.append(blk)
                ring.cur = ring.free.popleft()
                continue
            ring.cond.wait(timeout=0.05)
            if self._closed or self._stopped:
                raise ServerClosedError(
                    "PolicyServer is closing (arena ring drained for "
                    "shutdown)")

    # ---- expiry ------------------------------------------------------

    def _shed_expired(self, now: float) -> None:
        if self.data_plane == "legacy":
            self._shed_expired_legacy(now)
        else:
            self._shed_expired_arena(now)

    def _shed_expired_legacy(self, now: float) -> None:
        """Drop queued requests whose deadline passed (caller holds
        ``self._lock``). A full scan: deadlines are per request, so a
        generous head can hide an expired tail."""
        if not any(r.deadline_s is not None for r in self._pending):
            return
        keep: collections.deque[_Pending] = collections.deque()
        for r in self._pending:
            if (r.deadline_s is not None
                    and now - r.t_submit > r.deadline_s):
                self._reject(r.future, DeadlineSheddedError(
                    "expired", r.deadline_s, waited_s=now - r.t_submit,
                    req_id=r.req_id), reason="expired")
            else:
                keep.append(r)
        self._pending = keep

    def _shed_expired_arena(self, now: float) -> None:
        """Expired slots are marked dead in place (their rows become
        padding at the seal); the rejections fire outside the ring
        lock. A full scan, as on the legacy plane."""
        ring = self._ring
        if ring is None:
            return
        expired: "list[tuple[Future, float, float, int]]" = []
        with ring.lock:
            blocks = ring.blocks()
            if not any(b.n_deadlined for b in blocks):
                return
            for blk in blocks:
                for i in range(blk.claimed):
                    if not blk.published[i] or blk.dead[i]:
                        continue
                    d = blk.deadline[i]
                    if d is None:
                        continue
                    waited = now - blk.t_submit[i]
                    if waited > d:
                        blk.dead[i] = True
                        blk.n_dead += 1
                        blk.n_deadlined -= 1
                        ring.depth -= 1
                        expired.append((blk.futures[i], d, waited,
                                        int(blk.req[i])))
                        blk.futures[i] = None
        for fut, d, waited, rid in expired:
            self._reject(fut, DeadlineSheddedError(
                "expired", d, waited_s=waited, req_id=rid),
                reason="expired")

    # ---- adaptive hold -----------------------------------------------

    def _effective_wait(self) -> "float | None":
        """The partial-bucket hold for this pump (caller holds
        ``self._lock``, queue non-empty). Static mode returns the
        constructor's knob. Adaptive mode holds for the estimated time
        to fill the bucket at the observed arrival rate, clipped to the
        head-of-line deadline slack less one service time, and capped by
        ``max_wait_s`` when given."""
        if not self.adaptive_wait:
            return self.max_wait_s
        waits = []
        if self.max_wait_s is not None:
            waits.append(self.max_wait_s)
        gap = self._arrival_gap.value
        if gap is not None:
            free = max(self.engine.max_bucket - len(self._pending), 0)
            waits.append(gap * free)
        now = self._clock()
        slacks = [r.t_submit + r.deadline_s - now
                  for r in self._pending if r.deadline_s is not None]
        if slacks:
            svc = self._service_time.value or 0.0
            waits.append(max(min(slacks) - svc, 0.0))
        return min(waits) if waits else None

    # ---- pump --------------------------------------------------------

    def pump(self, max_wait_s: "float | None" = None) -> int:
        """Drain one coalesced batch: up to ``engine.max_bucket`` pending
        requests (FIFO), dispatched, the actions scattered to their
        futures. Returns the number served (0 = queue empty). On the
        arena plane the batch is one slab, sealed in place.

        ``max_wait_s`` (default: the constructor's policy; None = no
        wait) holds a PARTIAL bucket until it fills or the wait passes;
        with ``adaptive_wait`` the hold is learned per pump
        (:meth:`_effective_wait`). Expired deadlines shed before and
        after the hold. A :meth:`stop` drain cuts the wait short."""
        if self.data_plane == "legacy":
            return self._pump_legacy(max_wait_s)
        return self._pump_arena(max_wait_s)

    def _hold_for_bucket(self, pending_depth, max_wait_s: "float | None",
                         head_t_submit) -> None:
        """Partial-bucket hold (caller holds ``self._lock``).
        ``pending_depth``/``head_t_submit`` are callables so both planes
        share it. The sleep re-checks the depth AFTER counting itself in
        ``_sleepers``: with arena producers publishing outside this
        lock, that order (producer: publish, then read ``_sleepers``;
        consumer: count, then re-check) makes the wakeup race-free."""
        wait = (max_wait_s if max_wait_s is not None
                else self._effective_wait())
        if wait is None:
            return
        # static mode anchors at the head's submit time; adaptive mode
        # at now (its estimate already folds in the head's slack)
        if max_wait_s is None and self.adaptive_wait:
            anchor = self._clock()
        else:
            head = head_t_submit()
            anchor = head if head is not None else self._clock()
        deadline = anchor + wait
        with self.tracer.span("bucket_wait"):
            while (pending_depth() < self.engine.max_bucket
                   and not self._stopped):
                remaining = deadline - self._clock()
                if remaining <= 0:
                    break
                self._sleepers += 1
                try:
                    if (pending_depth() < self.engine.max_bucket
                            and not self._stopped):
                        self._wake.wait(timeout=remaining)
                finally:
                    self._sleepers -= 1

    def _pump_legacy(self, max_wait_s: "float | None") -> int:
        with self._lock:
            self._shed_expired(self._clock())
            if self._pending:
                self._hold_for_bucket(
                    lambda: len(self._pending), max_wait_s,
                    lambda: (self._pending[0].t_submit
                             if self._pending else None))
                self._shed_expired(self._clock())
            batch = [self._pending.popleft()
                     for _ in range(min(len(self._pending),
                                        self.engine.max_bucket))]
            self._depth.set(len(self._pending))
            self._inflight += bool(batch)
        if not batch:
            return 0
        n = len(batch)
        rids = [r.req_id for r in batch]
        t_disp = self._clock()
        try:
            with self.tracer.span("serve_batch", n=n):
                with self.tracer.span("stack"):
                    obs = stack_requests([r.obs for r in batch])
                    mask = stack_requests([r.mask for r in batch])
                    stall = np.asarray([r.stall for r in batch], np.int32)
                out, bucket = self.engine.decide(obs, mask, stall)
                actions, blp, bval = self._split_capture(out)
                now = self._clock()
                with self.tracer.span("scatter"):
                    per_req = scatter_results(actions, n)
            lats = [now - r.t_submit for r in batch]
            if self._flight_log is not None:
                # inside the try: a failing append fails the batch's
                # futures, never strands them
                self._log_rows(obs, mask, stall, actions, blp, bval, n,
                               lats, [r.deadline_s for r in batch], rids)
        except BaseException as e:
            self._end_dispatch(ran=True)
            for r in batch:
                if not r.future.cancelled():
                    r.future.set_exception(e)
            if self.tracer is not NULL_TRACER:
                self.tracer.instant("dispatch_failed", req_ids=rids,
                                    error=type(e).__name__)
            raise
        t_subs = [r.t_submit for r in batch]
        self._account_dispatch(now, t_disp, n, bucket, lats, t_subs, rids)
        for r, a, lat in zip(batch, per_req, lats):
            r.future.set_result(ServeResult(action=a, latency_s=lat,
                                            req_id=r.req_id))
        if self.tracer is not NULL_TRACER:
            self.tracer.instant(
                "served", bucket=bucket, req_ids=rids,
                wait_ms=[round((t_disp - t) * 1e3, 3) for t in t_subs],
                lat_ms=[round(l * 1e3, 3) for l in lats])
        return n

    def _seal_block(self, blk: _ArenaBlock):
        """Turn a taken block into a dispatchable contiguous prefix: wait
        out in-flight row copies (bounded by one memcpy: the producer
        reserved before the take) and compact live rows over dead ones
        (shed slots). Returns ``(n_live, futures, t_submits, deadlines,
        req_ids)``; ``req_ids`` is a view of the slab's lane, valid
        until the block recycles."""
        spin_deadline = time.monotonic() + 5.0
        while not all(blk.published[:blk.claimed]):
            if time.monotonic() > spin_deadline:
                # a producer died mid-copy (interpreter teardown): its
                # slot has no future holder, treat it as dead padding
                for i in range(blk.claimed):
                    if not blk.published[i]:
                        blk.published[i] = True
                        blk.dead[i] = True
                        blk.n_dead += 1
                break
            time.sleep(50e-6)
        live = [i for i in range(blk.claimed) if not blk.dead[i]]
        n_live = len(live)
        if n_live == 0:
            return 0, [], [], [], []
        if n_live != blk.claimed:
            # compact: shift live rows down over dead ones (dst <= src,
            # so in-place row moves are safe); the shed path only
            for dst, src in enumerate(live):
                if dst == src:
                    continue
                for leaf in blk.obs + blk.mask:
                    leaf[dst] = leaf[src]
                blk.stall[dst] = blk.stall[src]
                blk.req[dst] = blk.req[src]
                blk.futures[dst] = blk.futures[src]
                blk.t_submit[dst] = blk.t_submit[src]
                blk.deadline[dst] = blk.deadline[src]
        return (n_live, blk.futures[:n_live],
                blk.t_submit[:n_live], blk.deadline[:n_live],
                blk.req[:n_live])

    def _arena_views(self, blk: _ArenaBlock, n: int):
        """Contiguous ``[:n]`` views of the slabs, in the request rows'
        structure (views, never copies)."""
        obs = (blk.obs[0][:n] if self._obs_is_leaf else
               unflatten(self._obs_like, [x[:n] for x in blk.obs]))
        mask = (blk.mask[0][:n] if self._mask_is_leaf else
                unflatten(self._mask_like, [x[:n] for x in blk.mask]))
        return obs, mask, blk.stall[:n]

    def _scatter_arena(self, blk: _ArenaBlock, actions, n_live: int):
        """Per-request actions from the engine's actions buffers (one
        array, or a dict of per-head arrays). If the engine echoed its
        INPUT back (a host stub can), a buffer aliases the slab about to
        recycle: detected with a bounds-only overlap check and copied
        once, so a resolved result is never corrupted by slab reuse."""
        slabs = blk.obs + blk.mask + [blk.stall]
        safe = []
        for buf in leaves(actions):
            buf = np.asarray(buf)
            if any(np.may_share_memory(buf, s) for s in slabs):
                buf = buf.copy()
            safe.append(buf)
        if len(safe) == 1 and not isinstance(actions, (dict, tuple, list)):
            buf = safe[0]
            return [buf[i] for i in range(n_live)]
        return [unflatten(actions, [x[i] for x in safe])
                for i in range(n_live)]

    def _pump_arena(self, max_wait_s: "float | None") -> int:
        ring = self._ring
        if ring is None:
            return 0
        with self._lock:
            self._shed_expired(self._clock())
            if ring.depth > 0:
                self._hold_for_bucket(lambda: ring.depth, max_wait_s,
                                      ring.head_t_submit)
                self._shed_expired(self._clock())
            blk = ring.take_block()
            self._depth.set(ring.depth)
            self._inflight += blk is not None
        if blk is None:
            return 0
        t_disp = self._clock()
        try:
            n_live, futs, t_subs, deads, rids = self._seal_block(blk)
        except BaseException:
            self._end_dispatch(ran=False)
            ring.recycle(blk)
            raise
        if n_live == 0:
            self._end_dispatch(ran=False)
            ring.recycle(blk)
            return 0
        try:
            if self.tracer is NULL_TRACER:   # span-free hot path
                views = self._arena_views(blk, n_live)
                out, bucket = self.engine.decide(*views)
                actions, blp, bval = self._split_capture(out)
                now = self._clock()
                per_req = self._scatter_arena(blk, actions, n_live)
            else:
                with self.tracer.span("serve_batch", n=n_live):
                    with self.tracer.span("arena_seal"):
                        views = self._arena_views(blk, n_live)
                    out, bucket = self.engine.decide(*views)
                    actions, blp, bval = self._split_capture(out)
                    now = self._clock()
                    with self.tracer.span("scatter"):
                        per_req = self._scatter_arena(blk, actions, n_live)
            lats = [now - t for t in t_subs]
            if self._flight_log is not None:
                # the slab views stay valid until ring.recycle below, and
                # the writer copies the rows before it returns; inside
                # the try, so a failing append fails the batch's futures
                self._log_rows(*views, actions, blp, bval, n_live, lats,
                               deads, rids)
        except BaseException as e:
            self._end_dispatch(ran=True)
            for fut in futs:
                if not fut.cancelled():
                    fut.set_exception(e)
            if self.tracer is not NULL_TRACER:
                self.tracer.instant("dispatch_failed",
                                    req_ids=[int(r) for r in rids],
                                    error=type(e).__name__)
            ring.recycle(blk)
            raise
        self._account_dispatch(now, t_disp, n_live, bucket, lats,
                               t_subs, rids)
        for fut, a, lat, rid in zip(futs, per_req, lats, rids):
            try:
                fut.set_result(ServeResult(action=a, latency_s=lat,
                                           req_id=int(rid)))
            except BaseException:   # cancelled while in flight
                pass
        if self.tracer is not NULL_TRACER:
            # one instant per dispatch, not per request
            self.tracer.instant(
                "served", bucket=bucket,
                req_ids=[int(r) for r in rids],
                wait_ms=[round((t_disp - t) * 1e3, 3) for t in t_subs],
                lat_ms=[round(l * 1e3, 3) for l in lats])
        ring.recycle(blk)
        return n_live

    def _split_capture(self, out):
        """One dispatch's output as ``(actions, log_prob, value)``: a
        capture engine returns the triple, a plain engine the actions
        (log-prob and value None)."""
        if self._capture:
            return out
        return out, None, None

    def _log_rows(self, obs, mask, stall, actions, blp, bval, n: int,
                  lats: "list[float]", deads, req_ids) -> None:
        """Append this dispatch's ``n`` served rows to the flight log,
        each with its deadline outcome: 0 no deadline, 1 met, 2 served
        late (resolved past its deadline, not shed)."""
        # per call, not a shared scratch: dispatcher threads reach here
        # concurrently, and the writer copies only under its own lock
        outcome = np.zeros(n, np.int8)
        for i, d in enumerate(deads):
            if d is not None:
                outcome[i] = 1 if lats[i] <= d else 2
        head = lambda t: tree_map(lambda x: np.asarray(x)[:n], t)
        self._flight_log.append_batch(
            head(obs), head(mask), head(actions), np.asarray(blp)[:n],
            np.asarray(bval)[:n], np.asarray(stall)[:n], outcome,
            req_id=np.asarray(req_ids, np.int64)[:n])

    def _end_dispatch(self, ran: bool) -> None:
        """A taken batch that failed, or held no live row: it is no
        longer in flight (and, if it dispatched, it ended now)."""
        with self._lock:
            self._inflight -= 1
            if ran:
                self._t_dispatch_end = self._clock()

    def _account_dispatch(self, now: float, t_disp: float, n: int,
                          bucket: int, lats: "list[float]",
                          t_subs, req_ids) -> None:
        """Per-dispatch accounting under the consumer lock (dispatcher
        threads share every reservoir, counter and estimator below;
        producers never take this lock)."""
        with self._lock:
            self._inflight -= 1
            self._t_dispatch_end = now
            sample, svc = now - t_disp, self._service_time.value
            if self._relearn:
                self._relearn = False
                self._service_time.reset()
            elif svc is not None:
                sample = min(sample, SAMPLE_CAP * svc)
            self._service_time.update(sample)
            self._dispatches.inc()
            self._padded.inc(bucket - n)
            self._occupancy.set(n / bucket)
            self._occupancies.append(n / bucket)
            if self._t_first is None:
                self._t_first = min(t_subs)
            self._t_last = now if self._t_last is None else max(
                self._t_last, now)
            self._served += n
            for lat, t_sub, rid in zip(lats, t_subs, req_ids):
                self._latencies.append(lat)
                self._latency_req_ids.append(int(rid))
                self._latency_hist.observe(lat)
                self._queue_wait_hist.observe(max(t_disp - t_sub, 0.0))
            self._sample_window.set(len(self._latencies))

    # ---- live dispatcher ---------------------------------------------

    def _has_work(self) -> bool:
        if self.data_plane == "legacy":
            return bool(self._pending)
        ring = self._ring
        return ring is not None and ring.depth > 0

    def start(self, dispatchers: int = 1) -> None:
        """Start the background dispatchers: pump whenever requests are
        pending, each dispatch coalescing whatever arrived while the
        previous one ran. ``dispatchers > 1`` keeps that many pumps in
        flight at once, so a multi-engine router
        (:class:`.router.EngineRouter`) runs its engines concurrently;
        over one engine extra dispatchers only shrink batch occupancy.
        Warm the engines before starting (a capture while other engines
        replay is legal, but a cold bucket on the hot path is an
        alarm)."""
        if self._threads:
            raise RuntimeError("dispatcher already running")
        if self._closed:
            raise ServerClosedError("PolicyServer is closed")
        if dispatchers < 1:
            raise ValueError(f"dispatchers must be >= 1, got {dispatchers}")
        # every in-flight dispatcher can hold one block while another is
        # current and one stays free: the ring never wedges
        self._min_blocks = max(self._min_blocks, dispatchers + 2)
        if self._ring is not None:
            self._ring.grow(self._min_blocks)
        self._stopped = False

        def loop():
            while True:
                with self._wake:
                    while not self._has_work() and not self._stopped:
                        self._sleepers += 1
                        try:
                            if not self._has_work() and not self._stopped:
                                self._wake.wait()
                        finally:
                            self._sleepers -= 1
                    if self._stopped and not self._has_work():
                        return
                try:
                    self.pump()
                except Exception:
                    # the pump resolved its batch's futures with the
                    # exception (no silent drop); a dead dispatcher would
                    # strand every later request, so count and go on
                    self._dispatch_errors.inc()

        for i in range(dispatchers):
            t = threading.Thread(target=loop, name=f"serve-dispatcher-{i}",
                                 daemon=True)
            self._threads.append(t)
            t.start()

    def stop(self) -> None:
        """Stop the dispatcher after draining the queue. Submits are
        refused while the drain is in flight; once stopped the server is
        back in inline mode and :meth:`start` may be called again."""
        with self._wake:
            self._stopped = True
            self._wake.notify_all()
        for t in self._threads:
            t.join(timeout=30)
        self._threads = []
        with self._wake:
            # a close() drain is terminal; a stop() drain returns the
            # server to inline mode
            self._stopped = self._closed

    def close(self) -> None:
        """Permanent :meth:`stop`: drain the queue, stop the dispatcher,
        then refuse every later :meth:`submit` and :meth:`start` with
        :class:`ServerClosedError`. After ``close`` returns, every future
        ever handed out has resolved. Idempotent."""
        with self._wake:
            self._closed = True
        self.stop()
        # inline-mode close: flush what no dispatcher drained (each pump
        # consumes its batch even when the dispatch raises)
        while True:
            try:
                if not self.pump():
                    break
            except Exception:
                self._dispatch_errors.inc()
        # one final refresh, then detach from the scrape surface
        self.registry.collect()
        self.registry.remove_collector(self._refresh_slo_gauges)
        self.slo.close()

    @property
    def closed(self) -> bool:
        return self._closed

    def queue_depth(self) -> int:
        """Requests currently queued (the front door's backpressure
        signal; sampled, so a momentarily stale value is fine)."""
        if self.data_plane == "legacy":
            with self._lock:
                return len(self._pending)
        ring = self._ring
        return ring.depth if ring is not None else 0

    def service_time_s(self) -> "float | None":
        """The learned per-dispatch service time, ``None`` until the
        first dispatch (and after a fleet change)."""
        with self._lock:
            return self._service_time.value

    # ---- SLO surface -------------------------------------------------

    def slo_snapshot(self) -> dict:
        """Compute and publish the SLO numbers: p50/p99 decision latency
        (ms), decisions/s and per chip over the serving span (``n_chips``
        is the count of distinct devices the engine serves from: 1 for
        one engine, and for N routed engines sharing one card),
        mean batch occupancy, the SLO status."""
        lats = np.asarray(self._latencies, np.float64)
        span = ((self._t_last - self._t_first)
                if self._served and self._t_last is not None
                and self._t_first is not None else 0.0)
        n_chips = max(len(getattr(self.engine, "devices", ())), 1)
        dps = self._served / span if span > 0 else 0.0
        snap = {
            "requests": int(self._served),
            "dispatches": int(self._dispatches.value),
            "latency_p50_ms": (float(np.percentile(lats, 50)) * 1e3
                               if lats.size else None),
            "latency_p99_ms": (float(np.percentile(lats, 99)) * 1e3
                               if lats.size else None),
            "decisions_per_s": dps,
            "decisions_per_s_per_chip": dps / n_chips,
            "n_chips": n_chips,
            "batch_occupancy_mean": (float(np.mean(self._occupancies))
                                     if self._occupancies else None),
            "serving_span_s": span,
            "slo": self.slo.status(),
        }
        if lats.size and len(self._latency_req_ids) == lats.size:
            # exemplar: the request id of the sample nearest the p99
            # (ids exceed a float gauge's 2**53, so only this dict)
            p99 = float(np.percentile(lats, 99))
            snap["latency_p99_exemplar_req_id"] = int(
                self._latency_req_ids[int(np.argmin(np.abs(lats - p99)))])
        if lats.size:
            self.registry.gauge(
                "serve_decision_latency_p50_ms",
                "median submit->result decision latency").set(
                snap["latency_p50_ms"])
            self.registry.gauge(
                "serve_decision_latency_p99_ms",
                "p99 submit->result decision latency").set(
                snap["latency_p99_ms"])
        self.registry.gauge(
            "serve_decisions_per_s",
            "scheduling decisions served per second").set(dps)
        self.registry.gauge(
            "serve_decisions_per_s_per_chip",
            "decisions/s divided by local device count").set(
            dps / n_chips)
        return snap
