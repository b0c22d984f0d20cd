"""Baseline schedulers on the oracle simulator (L1/L6).

A numpy copy of the JAX package's ``sim/schedulers.py``: FIFO, SJF,
SRTF and a Tiresias-like discretized two-dimensional LAS, the
comparison rows of the JCT tables. All four share one event loop
(:func:`run_scheduler`): at every event the policy orders the jobs in
the system, and the loop admits them greedily in that order while the
gang fits, preempting (for a preemptive policy) any running job that
fell out of the admitted set.

Backends (:func:`run_baseline`): ``"native"`` runs the C++ engine of
:mod:`..native`, ``"python"`` the oracle here; both give the same
schedule. ``"auto"`` takes the native engine, and takes the Python
oracle only where no C++ compiler is on ``PATH``, saying so once on
stderr. A native engine that a present compiler fails to build or load
raises: it never turns into the Python oracle behind the caller's back.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, Sequence, runtime_checkable

import numpy as np

from .. import native
from ..traces.records import to_array_trace
from .oracle import PACK, PENDING, RUNNING, OracleSim

BACKENDS = ("auto", "python", "native")
# Tiresias's queue boundaries in GPU-seconds of attained service (the
# native engine holds the same pair)
TIRESIAS_THRESHOLDS = (3600.0, 36000.0)


@runtime_checkable
class BaselineResult(Protocol):
    """The finished-run surface every ``run_baseline`` backend returns:
    ``OracleSim`` (python) and ``native.NativeSimResult`` (C++)."""
    trace: "object"
    finish: np.ndarray   # per-row completion times (NaN on padding)
    start: np.ndarray    # per-row FIRST start times
    status: np.ndarray   # oracle status codes (DONE for completed jobs)

    def jcts(self) -> np.ndarray: ...
    def avg_jct(self) -> float: ...


@dataclasses.dataclass
class SchedulerPolicy:
    """A baseline: a priority key over in-system jobs + preemption flag.

    ``key(sim, j)``: lower sorts first. Non-preemptive policies keep
    running jobs running and only order the pending queue.
    ``next_wake(sim)``: the earliest future instant at which the
    policy's priorities change between events (a Tiresias demotion);
    the event loop advances to min(next event, next wake).
    """
    name: str
    key: Callable[[OracleSim, int], tuple]
    preemptive: bool = False
    next_wake: Callable[[OracleSim], float] = lambda s: float("inf")


def fifo() -> SchedulerPolicy:
    return SchedulerPolicy("fifo", lambda s, j: (s.trace.submit[j], j))


def sjf() -> SchedulerPolicy:
    """Shortest job first (non-preemptive, by total service demand)."""
    return SchedulerPolicy("sjf", lambda s, j: (s.trace.duration[j], j))


def srtf() -> SchedulerPolicy:
    """Shortest remaining time first (preemptive)."""
    return SchedulerPolicy("srtf", lambda s, j: (s.remaining[j], j),
                           preemptive=True)


def tiresias() -> SchedulerPolicy:
    """Tiresias-like discretized 2D-LAS: priority = attained GPU-service
    (gpus x executed seconds) discretized into queues by
    ``TIRESIAS_THRESHOLDS``;
    FIFO by submit time within a queue. Preemptive: new arrivals sit in
    the highest queue and can preempt demoted long-running jobs; wide
    gangs demote sooner because service is counted in GPU-seconds."""
    th = np.asarray(TIRESIAS_THRESHOLDS, np.float64)

    def key(s: OracleSim, j: int):
        q = int(np.searchsorted(th, s.attained_service(j), side="right"))
        return (q, s.trace.submit[j], j)

    def next_wake(s: OracleSim) -> float:
        """Earliest instant a running job's attained GPU-service crosses
        its next demotion threshold.

        Under faults a straggling gang attains service at ``1 / stretch``
        of the wall rate, so its crossing lies ``stretch`` times further
        out; and a wake that would move the job's remaining work by less
        than its f64 spacing (a crossing reached but for rounding) is
        passed over, the demotion left to the next event. JAX's wake
        ignores the stretch, so it comes early; near a crossing it then
        advances the clock one ulp at a time without changing any
        remaining work, and its loop never ends
        (``tests/test_torch_faults.py``). Without faults the wake is
        JAX's."""
        t = float("inf")
        stretch = s._stretch()
        for j in s.running_jobs():
            a = s.attained_service(j)
            nxt = th[np.searchsorted(th, a, side="right"):]
            if len(nxt):
                dt = (float(nxt[0]) - a) / float(s.trace.gpus[j])
                if s.faults is not None:
                    dt *= stretch[j]
                    if dt / stretch[j] < np.spacing(s.remaining[j]):
                        continue
                t = min(t, s.clock + dt)
        return t

    return SchedulerPolicy("tiresias", key, preemptive=True,
                           next_wake=next_wake)


BASELINES: dict[str, Callable[[], SchedulerPolicy]] = {
    "fifo": fifo, "sjf": sjf, "srtf": srtf, "tiresias": tiresias,
}


def schedule_step(sim: OracleSim, policy: SchedulerPolicy,
                  placement: int = PACK) -> None:
    """Apply one scheduling decision round at the current instant."""
    if policy.preemptive:
        insys = [j for j in range(sim.trace.max_jobs)
                 if sim.status[j] in (PENDING, RUNNING)]
        order = sorted(insys, key=lambda j: policy.key(sim, j))
        # greedy prefix admission: walk the priority order, keep or place
        # while the gang fits; anything running but not admitted is
        # preempted first so its GPUs are free for the admitted jobs
        budget = int(sim.effective_free().sum()) + \
            sum(int(sim.trace.gpus[j]) for j in sim.running_jobs())
        admitted = []
        for j in order:
            d = int(sim.trace.gpus[j])
            if d <= budget:
                admitted.append(j)
                budget -= d
        admitted_set = set(admitted)
        for j in sim.running_jobs():
            if j not in admitted_set:
                sim.preempt(j)
        for j in admitted:
            if sim.status[j] == PENDING:
                sim.try_place(j, placement)
    else:
        for j in sorted(sim.pending_jobs(), key=lambda j: policy.key(sim, j)):
            sim.try_place(j, placement)


def run_scheduler(sim: OracleSim, policy: SchedulerPolicy,
                  placement: int = PACK,
                  max_events: int = 10_000_000) -> OracleSim:
    """Run ``policy`` to trace completion; returns the finished sim."""
    sim.reset()
    for _ in range(max_events):
        schedule_step(sim, policy, placement)
        if sim.done():
            return sim
        t = min(sim.next_event_time(), policy.next_wake(sim))
        if not np.isfinite(t):
            raise RuntimeError("scheduler deadlock: pending jobs but no "
                               "events")
        if sim.advance_to(t) <= 0.0 and not sim.done():
            # zero-dt wake (threshold exactly at the clock): avoid spinning
            if sim.advance_to_next_event() == 0.0:
                raise RuntimeError("scheduler made no progress")
    raise RuntimeError("max_events exceeded")


def resolve_backend(backend: str = "auto") -> str:
    """The backend ``run_baseline`` will use: ``"native"`` or
    ``"python"``. ``"auto"`` is ``"python"`` only when no C++ compiler is
    on ``PATH`` (said once on stderr); ``"native"`` and ``"auto"`` with
    a compiler raise if the engine does not build or load."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "python":
        return backend
    if native.available():
        return "native"
    if backend == "native":
        raise RuntimeError(f"native backend unavailable: "
                           f"{native.build_error()}")
    native.warn_python_fallback()
    return "python"


def run_baseline(trace, n_nodes: int, gpus_per_node: int, name: str,
                 backend: str = "auto", faults=None) -> BaselineResult:
    """Run one named baseline over a trace; returns the finished run
    (the one implementation behind every baseline JCT table). See the
    module docstring for ``backend``.

    ``faults`` (one host fault or domain schedule) runs the baseline on
    the faulty cluster, the other side of a policy replayed under the
    same schedule. The native engine has no fault model, so a schedule
    runs the Python oracle, and ``backend="native"`` with one is
    refused."""
    if name not in BASELINES:
        raise ValueError(f"unknown baseline {name!r}")
    if faults is not None:
        if backend == "native":
            raise ValueError("the native backend has no fault model; run "
                             "faulty-cluster baselines on the python "
                             "oracle")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one "
                             f"of {BACKENDS}")
        sim = OracleSim(trace, n_nodes, gpus_per_node, faults=faults)
        return run_scheduler(sim, BASELINES[name]())
    if resolve_backend(backend) == "native":
        tr = to_array_trace(trace) if isinstance(trace, list) else trace
        finish, start = native.run_baseline_native(
            tr, n_nodes, gpus_per_node, name)
        return native.NativeSimResult(tr, finish, start)
    sim = OracleSim(trace, n_nodes, gpus_per_node)
    return run_scheduler(sim, BASELINES[name]())


def evaluate_baselines(trace, n_nodes: int, gpus_per_node: int,
                       names: Sequence[str] = ("fifo", "sjf", "srtf",
                                               "tiresias"),
                       ) -> dict[str, float]:
    """Avg-JCT table for the requested baselines on one trace."""
    return {name: run_baseline(trace, n_nodes, gpus_per_node, name).avg_jct()
            for name in names}
