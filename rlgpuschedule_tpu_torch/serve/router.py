"""Multi-engine serving of the port: the engine router, the serving fault
injector and the autoscale advisor.

Counterpart of the JAX package's ``serve/router.py``. The router holds N
:class:`~.engine.InferenceEngine` s behind one ``decide()`` and sends
each coalesced batch to the **least-loaded** active, healthy engine
(fewest dispatches in flight, then fewest rows served, then lowest id).
Each engine has its own copy of the policy, its own buffers and graphs
and, on the card, its own CUDA stream; its sentinel series carry its id
(``serve_recompile_alarms_total{engine="i"}``) in one registry.

**Devices.** JAX resolves one engine per data-axis device of its mesh
and refuses more engines than devices. The port's engines take their
devices from :func:`..device.serve_devices`, round-robin over the
visible devices, so N engines on one H100 share ``cuda:0``: they
overlap only as far as one card and one interpreter let them.

**Correctness contract.** Every engine runs the same decision on the
same weights, and the policies are row-wise, so a routed fleet's
per-request actions equal one engine's on the same requests, whichever
engine served which batch (``tests/test_torch_router.py``).

**Threads.** Engine selection and load accounting sit behind the
router's lock. On the CPU device work is serialized behind one dispatch
lock, as JAX's router serializes it there, so decisions/s does not scale
with engines on the CPU (:meth:`EngineRouter.serialized_dispatch`, the
bench's caveat); on the card the engines dispatch concurrently, each on
its own stream. A spin-up under load (:meth:`EngineRouter.set_active`
warming a cold engine) quiesces the router first: new dispatches wait
and those in flight finish, the cold engine captures its graphs on the
calling thread while no other thread touches the card, and serving
resumes. A capture on a dispatcher thread (a bucket never warmed) is a
recompile alarm, and on the card it may fail: warm every engine's
buckets before the dispatchers start.

**Health.** A failed dispatch is retried once on another healthy engine
(the retry hedge); ``eject_after`` consecutive failures eject an engine,
which is re-probed after an exponential back-off and readmitted when
its probe passes. :class:`ServeFaultInjector` fails engines on purpose
(``engine-raise``, ``engine-hang``, ``engine-slow``) for the chaos soak.

**Autoscale.** :class:`AutoscaleAdvisor` turns the server's SLO gauges
into a desired engine count with hysteresis, and
:meth:`EngineRouter.set_active` applies it live: a spin-up warms a cold
engine before it takes traffic, a drain stops routing to it.

A hierarchical policy is not routed: the mode table refuses ``router``
with ``hier`` in JAX's words (:mod:`..configs`).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import time
from typing import Any

from torch import nn

from ..device import serve_devices
from ..obs.metrics import Registry
from ..obs.trace import NULL_TRACER
from ..tree import leaves
from .batching import stack_requests
from .engine import InferenceEngine

SERVE_FAULT_KINDS = ("engine-raise", "engine-hang", "engine-slow")


class InjectedEngineFault(RuntimeError):
    """The exception an injected serving fault surfaces as: typed, so
    tests and the retry hedge can tell an injected crash from a real
    one."""


@dataclasses.dataclass
class ServeFaultSpec:
    """One armed serving fault: fires on the first not-yet-fired router
    dispatch with sequence number >= ``at`` that lands on ``engine``.

    ``>=`` rather than ``==`` on purpose: which engine serves dispatch N
    is a race between dispatcher threads, so an exact-match spec could
    miss its engine forever. Each spec still fires exactly once."""
    kind: str        # one of SERVE_FAULT_KINDS
    at: int          # router-global dispatch sequence number (>= fires)
    engine: int = 0  # target engine id
    fired: bool = False


def parse_serve_fault(spec: str) -> ServeFaultSpec:
    """Parse ``kind@N[:engine=E]`` (e.g. ``engine-raise@40``,
    ``engine-hang@10:engine=1``). Raises ValueError with the offending
    spec."""
    body = spec.strip()
    engine = 0
    if ":" in body:
        body, _, opt = body.partition(":")
        key, _, val = opt.partition("=")
        if key.strip() != "engine" or not val.strip().lstrip("-").isdigit():
            raise ValueError(f"bad serve-fault option {opt!r} in {spec!r} "
                             f"(expected engine=E)")
        engine = int(val)
    kind, sep, at = body.partition("@")
    kind = kind.strip()
    if kind not in SERVE_FAULT_KINDS or not sep or not at.strip().isdigit():
        raise ValueError(
            f"bad serve-fault spec {spec!r}; expected kind@N[:engine=E] "
            f"with kind in {SERVE_FAULT_KINDS}")
    return ServeFaultSpec(kind=kind, at=int(at), engine=engine)


class ServeFaultInjector:
    """Deterministic engine-fault injection: holds parsed specs, every
    hook is a no-op unless an armed spec matches, each spec fires
    exactly once, and a firing lands on the event bus before it takes
    effect. Three kinds, one per failure shape:

    - ``engine-raise``: the dispatch raises at once (a device error
      surfacing synchronously);
    - ``engine-hang``: the dispatch stalls ``hang_s``, then raises, as a
      hang reaped by a dispatch timeout would (bounded, so tests never
      hang);
    - ``engine-slow``: the dispatch stalls ``slow_s``, then SUCCEEDS (a
      brownout: health tracking must not eject for latency alone).
    """

    def __init__(self, specs: "list[ServeFaultSpec]", bus=None,
                 hang_s: float = 0.2, slow_s: float = 0.05):
        self.specs = list(specs)
        self._bus = bus
        self.hang_s = float(hang_s)
        self.slow_s = float(slow_s)
        self._lock = threading.Lock()

    def _take(self, engine: int, seq: int) -> "ServeFaultSpec | None":
        with self._lock:   # dispatcher threads race the same spec list
            for s in self.specs:
                if s.engine == engine and seq >= s.at and not s.fired:
                    s.fired = True
                    return s
        return None

    def _emit(self, spec: ServeFaultSpec, **fields: Any) -> None:
        if self._bus is not None:
            self._bus.emit("serve_fault", fault=spec.kind, at=spec.at,
                           engine=spec.engine, **fields)

    def on_dispatch(self, engine: int, seq: int) -> None:
        """The router calls this right before device work for dispatch
        ``seq`` on ``engine`` (probes included: a persistent fault keeps
        failing the re-probe and the engine stays ejected)."""
        spec = self._take(engine, seq)
        if spec is None:
            return
        self._emit(spec, dispatch=seq)
        if spec.kind == "engine-slow":
            time.sleep(self.slow_s)
            return
        if spec.kind == "engine-hang":
            time.sleep(self.hang_s)
            raise InjectedEngineFault(
                f"engine {engine} hung on dispatch {seq} (injected "
                f"{spec.kind}@{spec.at}, reaped after {self.hang_s}s)")
        raise InjectedEngineFault(
            f"engine {engine} raised on dispatch {seq} (injected "
            f"{spec.kind}@{spec.at})")


@dataclasses.dataclass
class EngineStats:
    """Point-in-time per-engine routing state (:meth:`EngineRouter.stats`)."""
    engine_id: int
    device: str            # str(device): placement, for humans and logs
    active: bool
    inflight: int          # dispatches on the engine now
    dispatches: int        # completed dispatches routed here, lifetime
    rows: int              # real request rows served, lifetime
    slots: int             # bucket rows dispatched (rows + padding)
    recompiles: int        # post-warmup recompile alarms (must stay 0)
    ejected: bool = False  # health-ejected (distinct from not active)
    consecutive_failures: int = 0

    @property
    def occupancy(self) -> "float | None":
        """Lifetime mean occupancy: real rows / bucket slots."""
        return self.rows / self.slots if self.slots else None


class EngineRouter:
    """N inference engines behind one ``decide()``.

    A drop-in for one :class:`~.engine.InferenceEngine` wherever the
    :class:`~.batching.PolicyServer` touches one (``decide``,
    ``max_bucket``, ``bucket_for``, ``warmup``,
    ``post_warmup_recompiles``, ``warmed_buckets``): point the server at
    a router and ``start(dispatchers=N)`` to keep N dispatches in
    flight. ``policy`` is copied into each engine (on its device).
    ``capture=True`` builds every engine in capture mode (``decide``
    returns the ``(actions, log_prob, value)`` triple).
    """

    def __init__(self, policy: nn.Module, env_params: Any = None,
                 max_bucket: int = 256, registry=None, bus=None,
                 strict: bool = False, tracer=None,
                 n_engines: "int | None" = None,
                 device=None,
                 fault_injector: "ServeFaultInjector | None" = None,
                 eject_after: int = 2, probe_backoff_s: float = 0.25,
                 probe_backoff_max_s: float = 8.0, clock=time.monotonic,
                 capture: bool = False):
        self.registry = registry if registry is not None else Registry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if eject_after < 1:
            raise ValueError(f"eject_after must be >= 1, got {eject_after}")
        if probe_backoff_s <= 0 or probe_backoff_max_s < probe_backoff_s:
            raise ValueError(
                f"need 0 < probe_backoff_s <= probe_backoff_max_s, got "
                f"{probe_backoff_s} / {probe_backoff_max_s}")
        devices = serve_devices(n_engines, device)
        n_engines = len(devices)
        # one engine per device slot, each on its own trace lane so the
        # pad/dispatch spans land on per-engine tracks in the timeline
        self.engines = [
            InferenceEngine(
                copy.deepcopy(policy).to(devices[i]), max_bucket=max_bucket,
                device=devices[i], env_params=env_params,
                registry=self.registry, bus=bus, strict=strict,
                tracer=self.tracer.lane(f"engine-{i}"), engine_id=i,
                capture=capture)
            for i in range(n_engines)
        ]
        # capture mode (the flywheel's tap): every engine returns the
        # (actions, log_prob, value) triple
        self.capture = bool(capture)
        self.max_bucket = max_bucket
        self.graphs = self.engines[0].graphs
        # device work is serialized on the CPU (as JAX's router does
        # there) and concurrent on the card
        self._on_cpu = devices[0].type == "cpu"
        self._device_lock = (threading.Lock() if self._on_cpu
                             else contextlib.nullcontext())
        self._lock = threading.Lock()
        # the quiesce gate: dispatches in flight, and whether a capture
        # holds the router quiet (new dispatches wait)
        self._gate = threading.Condition()
        self._dispatching = 0
        self._quiet = False
        self._active = [True] * n_engines
        self._inflight = [0] * n_engines
        self._rows = [0] * n_engines
        self._slots = [0] * n_engines
        self._dispatch_counts = [0] * n_engines
        self._example: "tuple[Any, Any] | None" = None
        # ---- health tracking (ejection, back-off re-probe) -----------
        self._bus = bus
        self._injector = fault_injector
        self.eject_after = int(eject_after)
        self.probe_backoff_s = float(probe_backoff_s)
        self.probe_backoff_max_s = float(probe_backoff_max_s)
        self._clock = clock
        self._dispatch_seq = 0          # router-global, probes included
        self._consec_fail = [0] * n_engines
        self._ejected = [False] * n_engines
        self._eject_until = [0.0] * n_engines
        self._backoff = [float(probe_backoff_s)] * n_engines
        self._probing = [False] * n_engines

        def per_engine(kind, name, help):
            return [getattr(self.registry, kind)(
                name, help, labels={"engine": str(i)})
                for i in range(n_engines)]

        self._eng_dispatches = per_engine(
            "counter", "serve_engine_dispatches_total",
            "batch dispatches routed to this engine")
        self._eng_rows = per_engine(
            "counter", "serve_engine_rows_total",
            "real request rows served by this engine")
        self._eng_occupancy = per_engine(
            "gauge", "serve_engine_occupancy",
            "real rows / bucket rows of this engine's last dispatch")
        self._eng_failures = per_engine(
            "counter", "serve_engine_failures_total",
            "dispatches on this engine that raised (probe failures "
            "included)")
        self._eng_ejections = per_engine(
            "counter", "serve_engine_ejections_total",
            "times this engine was health-ejected from routing after "
            "consecutive dispatch failures")
        self._eng_readmissions = per_engine(
            "counter", "serve_engine_readmissions_total",
            "times this engine passed its re-probe and rejoined routing")
        self._retries = self.registry.counter(
            "serve_retry_hedges_total",
            "batches retried once on a healthy engine after their first "
            "engine's dispatch failed")
        self._g_ejected = self.registry.gauge(
            "serve_engines_ejected", "engines currently health-ejected")
        self._g_total = self.registry.gauge(
            "serve_engines_total", "engines of the router")
        self._g_active = self.registry.gauge(
            "serve_engines_active", "engines currently taking traffic")
        self._g_total.set(n_engines)
        self._g_active.set(n_engines)
        # fired after a set_active that re-warmed or resized the fleet,
        # and after a weight swap: the PolicyServer resets its learned
        # service time there
        self._rewarm_listeners: "list[Any]" = []

    def add_rewarm_listener(self, cb) -> None:
        """Register ``cb()`` to run after :meth:`set_active` changes the
        fleet (a spin-up warm or an active-count change) and after
        :meth:`swap_params`. Callbacks must be cheap and must not raise;
        they run outside the router's locks."""
        self._rewarm_listeners.append(cb)

    # ---- engine-interface parity -------------------------------------

    @property
    def n_engines(self) -> int:
        return len(self.engines)

    @property
    def n_active(self) -> int:
        with self._lock:
            return sum(self._active)

    @property
    def devices(self) -> tuple:
        """The distinct devices the engines serve from (one on one card,
        however many engines share it)."""
        return tuple(dict.fromkeys(e.device for e in self.engines))

    @property
    def post_warmup_recompiles(self) -> int:
        """Fleet-aggregate recompile alarms; :meth:`per_engine_recompiles`
        carries the per-engine contract (each must be 0 on its own)."""
        return sum(e.post_warmup_recompiles for e in self.engines)

    def per_engine_recompiles(self) -> "list[int]":
        return [e.post_warmup_recompiles for e in self.engines]

    @property
    def warmed_buckets(self) -> "tuple[int, ...]":
        return self.engines[0].warmed_buckets

    def bucket_for(self, n: int) -> int:
        return self.engines[0].bucket_for(n)

    def serialized_dispatch(self) -> bool:
        """True when device work is serialized behind the CPU dispatch
        lock: the bit the bench reports beside its decisions/s."""
        return self._on_cpu

    # ---- dispatch ----------------------------------------------------

    def _acquire(self, exclude: "int | None" = None) -> int:
        """Pick the least-loaded active, healthy engine and book an
        inflight slot (fewest inflight, then fewest lifetime rows, then
        lowest id). ``exclude`` bars the engine a retry hedge just failed
        on."""
        with self._lock:
            candidates = [i for i in range(len(self.engines))
                          if self._active[i] and not self._ejected[i]
                          and i != exclude]
            if not candidates:
                raise RuntimeError("no active healthy engines")
            eid = min(candidates,
                      key=lambda i: (self._inflight[i], self._rows[i], i))
            self._inflight[eid] += 1
            return eid

    def _release(self, eid: int, rows: int, bucket: "int | None") -> None:
        with self._lock:
            self._inflight[eid] -= 1
            if bucket is not None:        # the dispatch completed
                self._rows[eid] += rows
                self._slots[eid] += bucket
                self._dispatch_counts[eid] += 1
                self._eng_dispatches[eid].inc()
                self._eng_rows[eid].inc(rows)
                self._eng_occupancy[eid].set(rows / bucket)

    def _next_seq(self) -> int:
        with self._lock:
            seq = self._dispatch_seq
            self._dispatch_seq += 1
            return seq

    @contextlib.contextmanager
    def _device_work(self):
        """Device work of one dispatch: waits while the router is held
        quiet for a capture, and is counted so a capture can wait for it
        to finish; serialized behind the dispatch lock on the CPU."""
        with self._gate:
            while self._quiet:
                self._gate.wait()
            self._dispatching += 1
        try:
            with self._device_lock:
                yield
        finally:
            with self._gate:
                self._dispatching -= 1
                self._gate.notify_all()

    @contextlib.contextmanager
    def _quiesced(self):
        """Hold the router quiet: new dispatches wait and the ones in
        flight finish before the body runs (one quiesce at a time)."""
        with self._gate:
            while self._quiet:
                self._gate.wait()
            self._quiet = True
            while self._dispatching:
                self._gate.wait()
        try:
            yield
        finally:
            with self._gate:
                self._quiet = False
                self._gate.notify_all()

    def _dispatch_on(self, eid: int, obs: Any, mask: Any, stall,
                     n: int) -> "tuple[Any, int]":
        """One booked dispatch on engine ``eid`` (inflight slot already
        acquired; always released). The fault injector is consulted with
        a fresh router-global sequence number right before device
        work."""
        seq = self._next_seq()
        bucket = None
        try:
            with self._device_work():
                if self._injector is not None:
                    self._injector.on_dispatch(eid, seq)
                actions, bucket = self.engines[eid].decide(obs, mask, stall)
        finally:
            self._release(eid, n, bucket)
        return actions, bucket

    def _note_success(self, eid: int) -> None:
        with self._lock:
            self._consec_fail[eid] = 0

    def _note_failure(self, eid: int, exc: BaseException) -> None:
        """Record one dispatch failure; eject the engine once it reaches
        ``eject_after`` CONSECUTIVE failures (one transient error never
        drains capacity). An ejection arms the back-off re-probe and is
        loud: a bus event, a per-engine counter, a lane instant."""
        fields = None
        with self._lock:
            self._eng_failures[eid].inc()
            self._consec_fail[eid] += 1
            if (not self._ejected[eid]
                    and self._consec_fail[eid] >= self.eject_after):
                self._ejected[eid] = True
                backoff = self._backoff[eid]
                self._eject_until[eid] = self._clock() + backoff
                self._backoff[eid] = min(backoff * 2,
                                         self.probe_backoff_max_s)
                self._eng_ejections[eid].inc()
                self._g_ejected.set(sum(self._ejected))
                fields = dict(engine=eid,
                              consecutive_failures=self._consec_fail[eid],
                              backoff_s=backoff,
                              error=type(exc).__name__)
        if fields is not None:
            if self._bus is not None:
                self._bus.emit("engine_eject", **fields)
            self.engines[eid].tracer.instant("eject", **fields)

    def _probe(self, eid: int) -> bool:
        """Re-probe an ejected engine: a blessed re-warm (a warm engine's
        buckets are remembered, so it builds nothing) then ONE real 1-row
        dispatch through the fault injector, straight on the engine so
        probe rows never enter the routing row accounting. True =
        healthy, readmit."""
        if self._example is None:
            return True        # nothing to probe with; trust the retry
        obs = stack_requests([self._example[0]])
        mask = stack_requests([self._example[1]])
        try:
            with self.engines[eid].tracer.span("rewarm_probe"):
                seq = self._next_seq()
                with self._device_work():
                    if self._injector is not None:
                        self._injector.on_dispatch(eid, seq)
                    self.engines[eid].warmup(*self._example)
                    self.engines[eid].decide(obs, mask, None)
            return True
        except Exception:
            with self._lock:
                self._eng_failures[eid].inc()
            return False

    def _maybe_readmit(self) -> None:
        """Give every ejected engine whose back-off has elapsed one
        re-probe; readmit on success (failure streak and back-off
        reset), push the next probe out exponentially on failure. Called
        at decide time: probes ride the request stream, no extra
        thread."""
        with self._lock:
            if not any(self._ejected):
                return
            now = self._clock()
            due = [i for i in range(len(self.engines))
                   if self._ejected[i] and not self._probing[i]
                   and now >= self._eject_until[i]]
            for i in due:
                self._probing[i] = True
        for i in due:
            ok = self._probe(i)
            with self._lock:
                self._probing[i] = False
                if ok:
                    self._ejected[i] = False
                    self._consec_fail[i] = 0
                    self._backoff[i] = self.probe_backoff_s
                    self._eng_readmissions[i].inc()
                    self._g_ejected.set(sum(self._ejected))
                else:
                    self._eject_until[i] = (self._clock()
                                            + self._backoff[i])
                    self._backoff[i] = min(self._backoff[i] * 2,
                                           self.probe_backoff_max_s)
            if ok:
                if self._bus is not None:
                    self._bus.emit("engine_readmit", engine=i)
                self.engines[i].tracer.instant("readmit")

    def decide(self, obs: Any, mask: Any, stall=None) -> "tuple[Any, int]":
        """One routed batch decision, with the signature and result of
        :meth:`.engine.InferenceEngine.decide`.

        A failed dispatch is retried ONCE on a different healthy engine
        (the hedge, counted in ``serve_retry_hedges_total``); if the
        retry fails too, or no healthy engine remains, the exception
        propagates and the batching layer resolves every affected future
        with it. Nothing is dropped silently."""
        n = int(leaves(obs)[0].shape[0])
        self._maybe_readmit()
        eid = self._acquire()
        try:
            out = self._dispatch_on(eid, obs, mask, stall, n)
        except Exception as first:
            self._note_failure(eid, first)
            try:
                retry_eid = self._acquire(exclude=eid)
            except RuntimeError:
                raise first
            self._retries.inc()
            if self._bus is not None:
                self._bus.emit("serve_retry", from_engine=eid,
                               to_engine=retry_eid,
                               error=type(first).__name__)
            try:
                with self.engines[retry_eid].tracer.span(
                        "retry_hedge", from_engine=eid):
                    out = self._dispatch_on(retry_eid, obs, mask, stall, n)
            except Exception as second:
                self._note_failure(retry_eid, second)
                raise
            self._note_success(retry_eid)
            return out
        self._note_success(eid)
        return out

    # ---- warmup, live resize, weight swap ----------------------------

    def _fire_rewarm(self) -> None:
        for cb in list(self._rewarm_listeners):
            cb()

    def warmup(self, example_obs: Any, example_mask: Any,
               buckets: "tuple[int, ...]" = ()) -> "tuple[int, ...]":
        """Warm every ACTIVE engine's buckets (blessed builds), one after
        another, and remember the example so :meth:`set_active` can warm
        engines it spins up later. Returns the buckets the first engine
        warmed."""
        self._example = (example_obs, example_mask)
        done: "tuple[int, ...]" = ()
        for i, e in enumerate(self.engines):
            with self._lock:
                active = self._active[i]
            if not active:
                continue
            with self._device_lock:
                out = e.warmup(example_obs, example_mask, buckets)
            if i == 0:
                done = out
        return done

    def set_active(self, k: int) -> int:
        """Resize the serving fleet to the first ``k`` engines (clamped
        to ``[1, n_engines]``). A spin-up warms a cold engine FIRST, on
        the calling thread with the router held quiet (its builds are
        blessed; it takes no traffic until warm); a drain only stops
        routing (inflight dispatches finish, the warmed buckets are
        kept, so re-activation is free). Call it from a thread that is
        not dispatching. Returns the applied count."""
        k = max(1, min(int(k), len(self.engines)))
        with self._lock:
            need_warm = [i for i in range(k)
                         if not self._active[i]
                         and self.engines[i].warmed_buckets == ()]
        if self._example is not None and need_warm:
            with self._quiesced(), self._device_lock:
                for i in need_warm:
                    self.engines[i].warmup(*self._example)
        with self._lock:
            changed = bool(need_warm) or sum(self._active) != k
            for i in range(len(self.engines)):
                self._active[i] = i < k
            self._g_active.set(k)
        if changed:
            # the service-time distribution just changed: listeners drop
            # their stale estimates
            self._fire_rewarm()
        return k

    def swap_params(self, state_dict: "dict[str, Any]") -> "tuple[int, ...]":
        """Live fleet-wide weight swap: EVERY engine, active or drained,
        gets the new weights (a drained engine must never rejoin with
        stale ones), each under the device lock; then every warmed
        engine runs a blessed :meth:`~.engine.InferenceEngine.rewarm`
        that builds nothing (a build there is a recompile alarm). Fires
        the rewarm listeners last. Returns the buckets re-driven on
        engine 0."""
        driven: "tuple[int, ...]" = ()
        for i, e in enumerate(self.engines):
            with self._device_lock:
                e.set_params(state_dict)
                if e.warmed_buckets:
                    out = e.rewarm()
                    if i == 0:
                        driven = out
        self._fire_rewarm()
        return driven

    def apply_autoscale(self, advisor: "AutoscaleAdvisor") -> int:
        """One autoscale tick: let ``advisor`` vote on the SLO surface,
        and apply its (hysteresis-filtered) engine count live. Returns
        the active count after it."""
        return self.set_active(advisor.observe())

    # ---- introspection -----------------------------------------------

    def stats(self) -> "list[EngineStats]":
        with self._lock:
            return [EngineStats(
                engine_id=i,
                device=str(self.engines[i].device),
                active=self._active[i],
                inflight=self._inflight[i],
                dispatches=self._dispatch_counts[i],
                rows=self._rows[i],
                slots=self._slots[i],
                recompiles=self.engines[i].post_warmup_recompiles,
                ejected=self._ejected[i],
                consecutive_failures=self._consec_fail[i])
                for i in range(len(self.engines))]

    def fault_stats(self) -> dict:
        """Fleet-aggregate health numbers for the soak reports."""
        with self._lock:
            return {
                "failures": int(sum(c.value for c in self._eng_failures)),
                "ejections": int(sum(c.value
                                     for c in self._eng_ejections)),
                "readmissions": int(sum(c.value
                                        for c in self._eng_readmissions)),
                "retry_hedges": int(self._retries.value),
                "engines_ejected": int(sum(self._ejected)),
            }


class AutoscaleAdvisor:
    """SLO gauges -> desired engine count, with hysteresis.

    Reads the registry surface the server exports
    (``serve_decision_latency_p99_ms``, ``serve_queue_depth``,
    ``serve_batch_occupancy``, ``serve_shed_total``) and votes each
    :meth:`observe` tick:

    - **up** when p99 is over ``p99_target_ms``, the queue is past
      ``queue_high``, or ANY request was shed since the last tick;
    - **down** when capacity is clearly idle: occupancy under
      ``occupancy_low`` with an empty queue, no shedding, and p99 under
      half the target;
    - **hold** otherwise.

    A vote moves the desired count only after ``hysteresis``
    CONSECUTIVE same-direction votes (a mixed or hold vote resets the
    streak), so a steady load cannot flap the fleet. The desired count
    is the ``serve_autoscale_desired_engines`` gauge; changes count in
    ``serve_autoscale_resizes_total``.
    """

    def __init__(self, registry, n_max: int, n_min: int = 1,
                 initial: "int | None" = None,
                 p99_target_ms: float = 50.0, queue_high: int = 64,
                 occupancy_low: float = 0.25, hysteresis: int = 3):
        if n_min < 1 or n_max < n_min:
            raise ValueError(f"need 1 <= n_min <= n_max, got "
                             f"n_min={n_min}, n_max={n_max}")
        if hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {hysteresis}")
        self.registry = registry
        self.n_min = int(n_min)
        self.n_max = int(n_max)
        self.p99_target_ms = float(p99_target_ms)
        self.queue_high = int(queue_high)
        self.occupancy_low = float(occupancy_low)
        self.hysteresis = int(hysteresis)
        self.desired = (int(initial) if initial is not None else n_max)
        self.desired = max(self.n_min, min(self.desired, self.n_max))
        self._streak = 0          # signed: +k = k up votes in a row
        self._shed_seen = 0.0
        self._g_desired = registry.gauge(
            "serve_autoscale_desired_engines",
            "engine count the autoscale advisor currently wants")
        self._resizes = registry.counter(
            "serve_autoscale_resizes_total",
            "times the advisor changed its desired engine count")
        self._g_desired.set(self.desired)

    def _vote(self) -> int:
        # registry.gauge() returns the shared series; an unset gauge
        # reads 0, which only ever suppresses a vote
        p99 = self.registry.gauge("serve_decision_latency_p99_ms").value
        depth = self.registry.gauge("serve_queue_depth").value
        occ = self.registry.gauge("serve_batch_occupancy").value
        shed = self.registry.counter("serve_shed_total").value
        shed_delta = shed - self._shed_seen
        self._shed_seen = shed
        if (shed_delta > 0 or depth > self.queue_high
                or (p99 > 0 and p99 > self.p99_target_ms)):
            return 1
        if (depth == 0 and shed_delta == 0 and occ < self.occupancy_low
                and p99 < self.p99_target_ms / 2):
            return -1
        return 0

    def observe(self) -> int:
        """One tick: run the registry's collectors (the gauges and SLO
        windows are fresh), fold the vote into the hysteresis streak,
        and return the (possibly updated) desired engine count."""
        self.registry.collect()
        v = self._vote()
        if v == 0:
            self._streak = 0
        elif v * self._streak >= 0:
            self._streak += v
        else:
            self._streak = v
        if abs(self._streak) >= self.hysteresis:
            new = max(self.n_min, min(self.desired + v, self.n_max))
            if new != self.desired:
                self.desired = new
                self._resizes.inc()
                self._g_desired.set(new)
            self._streak = 0
        return self.desired
