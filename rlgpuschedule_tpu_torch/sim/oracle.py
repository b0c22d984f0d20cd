"""Exact event-driven oracle simulator (L1), the executable spec.

A numpy copy of the JAX package's ``sim/oracle.py``: the slow, plainly
correct Python form of the cluster semantics that the batched
simulator (:mod:`.core`) reproduces and that the baseline schedulers
(:mod:`.schedulers`) run on. Same trace, same schedule, bit for bit
(``tests/test_torch_oracle.py``).

Semantics:

- Cluster: ``n_nodes`` x ``gpus_per_node`` interchangeable GPUs; jobs may
  span nodes; gang all-or-nothing: a job runs only with its full demand.
- Job lifecycle: NOT_ARRIVED -> PENDING (clock >= submit) -> RUNNING ->
  DONE. Preemption: RUNNING -> PENDING with attained service kept.
- Placement is deterministic given the free-GPU vector:
  PACK fills nodes by (free desc, node id asc); SPREAD water-fills
  (smallest level t with sum(min(free, t)) >= demand, the excess
  trimmed from the highest node ids allocated exactly t).
- Time advances only between decision points, to the next event:
  min(next arrival, next completion, next fault transition);
  completions are processed before drain kills, and drain kills before
  arrivals, at the same instant.
- JCT(j) = finish(j) - submit(j).

``faults`` (one host :class:`.faults.FaultSchedule`, or a
:class:`..domains.DomainSchedule` whose per-node capacity sizes the
cluster) attaches the fault process the batched simulator implements:
a drained node offers no placement capacity and kills its running jobs
back to PENDING with their attained service kept; a straggler stretches
remaining work (a gang runs at its slowest node's speed); drain starts
and node returns are events.
"""
from __future__ import annotations

import numpy as np

from ..traces.records import ArrayTrace, JobRecord, to_array_trace
from .faults import validate_fault_schedule

NOT_ARRIVED, PENDING, RUNNING, DONE = 0, 1, 2, 3
PACK, SPREAD = 0, 1


def pack_placement(free: np.ndarray, demand: int) -> np.ndarray | None:
    """Fill the freest nodes first; ties broken by lowest node id."""
    if demand > int(free.sum()):
        return None
    order = np.lexsort((np.arange(len(free)), -free))  # free desc, id asc
    alloc = np.zeros_like(free)
    left = demand
    for n in order:
        take = min(int(free[n]), left)
        alloc[n] = take
        left -= take
        if left == 0:
            break
    return alloc


def spread_placement(free: np.ndarray, demand: int) -> np.ndarray | None:
    """Water-filling: balance the allocation as evenly as the free vector
    allows. Excess (when sum(min(free, t)) overshoots) is trimmed from
    the highest node ids among nodes allocated exactly t."""
    if demand > int(free.sum()):
        return None
    t = 0
    while int(np.minimum(free, t).sum()) < demand:
        t += 1
    alloc = np.minimum(free, t).astype(free.dtype)
    excess = int(alloc.sum()) - demand
    if excess > 0:
        at_t = [n for n in range(len(free)) if alloc[n] == t]
        for n in sorted(at_t, reverse=True)[:excess]:
            alloc[n] -= 1
    return alloc


class OracleSim:
    """Exact discrete-event simulation of one cluster over one trace."""

    def __init__(self, trace: ArrayTrace | list[JobRecord], n_nodes: int,
                 gpus_per_node: int, faults=None):
        if isinstance(trace, list):
            trace = to_array_trace(trace)
        self.trace = trace
        self.n_nodes = n_nodes
        self.gpus_per_node = gpus_per_node
        # a domain schedule's capacity is read before validation, which
        # keeps only the three fault fields
        cap = getattr(faults, "capacity", None)
        self.node_capacity = (np.full(n_nodes, gpus_per_node, np.int32)
                              if cap is None
                              else np.asarray(cap, np.int32).copy())
        if self.node_capacity.shape != (n_nodes,):
            raise ValueError(
                f"domain capacity must have shape ({n_nodes},); got "
                f"{self.node_capacity.shape}")
        self.capacity = int(self.node_capacity.sum())
        if trace.num_jobs and \
                int(trace.gpus[trace.valid].max()) > self.capacity:
            raise ValueError("a job demands more GPUs than the cluster has")
        self.faults = (None if faults is None
                       else validate_fault_schedule(n_nodes, faults))
        self.reset()

    def reset(self):
        J = self.trace.max_jobs
        self.clock = 0.0
        self.status = np.where(self.trace.valid, NOT_ARRIVED,
                               DONE).astype(np.int32)
        self.remaining = self.trace.duration.astype(np.float64).copy()
        self.start = np.full(J, np.nan)
        self.finish = np.full(J, np.nan)
        self.alloc = np.zeros((J, self.n_nodes), np.int32)
        self.free = self.node_capacity.copy()
        self._process_arrivals()
        return self

    # ---- events ------------------------------------------------------------

    def _process_arrivals(self):
        arrived = (self.status == NOT_ARRIVED) & \
            (self.trace.submit <= self.clock)
        self.status[arrived] = PENDING

    def node_up(self, t: float | None = None) -> np.ndarray:
        """bool[N]: nodes serving at ``t`` (default the clock; down on
        [start, end))."""
        if self.faults is None:
            return np.ones(self.n_nodes, bool)
        t = self.clock if t is None else t
        f = self.faults
        return ~((f.down_start <= t) & (t < f.down_end)).any(axis=1)

    def effective_free(self) -> np.ndarray:
        """Placement's view of free GPUs: drained nodes offer none."""
        if self.faults is None:
            return self.free
        return np.where(self.node_up(), self.free, 0).astype(self.free.dtype)

    def _stretch(self) -> np.ndarray:
        """f64[J] work stretch per job: a gang runs at its slowest node's
        speed; 1 with no faults or no allocation."""
        if self.faults is None:
            return np.ones(self.trace.max_jobs)
        slow = np.asarray(self.faults.slowdown, np.float64)
        return np.where(self.alloc > 0, slow[None, :], 1.0).max(axis=1)

    def next_event_time(self) -> float:
        """Earliest future arrival, completion or fault transition; +inf
        if none exists."""
        t = np.inf
        na = self.status == NOT_ARRIVED
        if na.any():
            t = min(t, float(self.trace.submit[na].min()))
        run = self.status == RUNNING
        if run.any():
            eta = self.remaining[run] * self._stretch()[run]
            t = min(t, self.clock + float(eta.min()))
        if self.faults is not None:
            times = np.concatenate([
                np.asarray(self.faults.down_start, np.float64).ravel(),
                np.asarray(self.faults.down_end, np.float64).ravel()])
            future = times[times > self.clock]
            if future.size:
                t = min(t, float(future.min()))
        return t

    def advance_to(self, t: float) -> float:
        """Advance the clock to ``t`` (<= next event time; schedulers may
        pass an earlier timer wake, e.g. a Tiresias demotion instant).
        Completions falling exactly on ``t`` are processed first, then
        the drain kills (jobs on nodes down at ``t`` back to PENDING,
        their service kept), then arrivals. Returns dt."""
        if not np.isfinite(t):
            return 0.0
        if t > self.next_event_time() + 1e-9:
            raise ValueError("advance_to would skip over an event")
        dt = t - self.clock
        run = self.status == RUNNING
        self.remaining[run] -= dt / self._stretch()[run]
        self.clock = t
        completed = run & (self.remaining <= 1e-9)
        for j in np.flatnonzero(completed):
            self.status[j] = DONE
            self.finish[j] = t
            self.remaining[j] = 0.0
            self.free += self.alloc[j]
            self.alloc[j] = 0
        if self.faults is not None:
            down = ~self.node_up()
            killed = (self.status == RUNNING) & \
                ((self.alloc > 0) & down[None, :]).any(axis=1)
            for j in np.flatnonzero(killed):
                self.free += self.alloc[j]
                self.alloc[j] = 0
                self.status[j] = PENDING
        self._process_arrivals()
        return dt

    def advance_to_next_event(self) -> float:
        """Advance the clock to the next event; returns dt (0 if none)."""
        return self.advance_to(self.next_event_time())

    # ---- scheduling actions ------------------------------------------------

    def try_place(self, j: int, mode: int = PACK) -> bool:
        """Gang-place pending job j; False if infeasible or not pending.
        Drained nodes offer no GPUs, so a gang never lands on one."""
        if self.status[j] != PENDING:
            return False
        demand = int(self.trace.gpus[j])
        place = (pack_placement if mode == PACK
                 else spread_placement)(self.effective_free(), demand)
        if place is None:
            return False
        self.alloc[j] = place
        self.free -= place
        self.status[j] = RUNNING
        if np.isnan(self.start[j]):
            self.start[j] = self.clock
        return True

    def preempt(self, j: int) -> bool:
        if self.status[j] != RUNNING:
            return False
        self.free += self.alloc[j]
        self.alloc[j] = 0
        self.status[j] = PENDING
        return True

    def rl_step(self, action: int, queue_len: int, n_placements: int = 1,
                n_preempt: int = 0) -> dict:
        """One RL decision-point step, the semantics the batched
        ``core.rl_step`` reproduces.

        Action layout ``[K*P placements][R preemptions][no-op]``:
        ``action < K*P`` places slot ``action // n_placements`` of the
        pending queue with mode ``action % n_placements`` (0 pack,
        1 spread); ``K*P <= action < K*P + n_preempt`` preempts slot
        ``action - K*P`` of the running queue (most attained GPU-service
        first); anything else is a no-op.

        A successful placement or preemption costs no simulated time. A
        no-op, invalid or infeasible action advances the clock to the
        next event; if no future event exists (nothing running, so the
        cluster is free) the head of the queue is force-placed, which
        always fits because no job demands more than the cluster has.
        """
        n_place = queue_len * n_placements
        queue = self.pending_jobs()[:queue_len]
        placed = preempted = first_placed = False
        if action < n_place:
            k, p = divmod(action, n_placements)
            if k < len(queue):
                first = bool(np.isnan(self.start[queue[k]]))
                placed = self.try_place(queue[k], p)
                first_placed = placed and first
        elif action < n_place + n_preempt:
            run_q = self.running_queue(n_preempt)
            r = action - n_place
            if r < len(run_q):
                preempted = self.preempt(run_q[r])
        dt, n_before = 0.0, self.in_system()
        if not (placed or preempted):
            t = self.next_event_time()
            if np.isfinite(t):
                dt = self.advance_to(t)
            elif queue:
                first = bool(np.isnan(self.start[queue[0]]))
                placed = self.try_place(queue[0], PACK)
                first_placed = placed and first
        return {"placed": placed, "dt": dt, "in_system_before": n_before,
                "done": self.done(), "preempted": preempted,
                "first_placed": first_placed}

    # ---- queries -----------------------------------------------------------

    def pending_jobs(self) -> list[int]:
        """Pending job ids ordered by (submit asc, id asc), the queue
        order the RL action space indexes into."""
        pend = np.flatnonzero(self.status == PENDING)
        return sorted(pend, key=lambda j: (self.trace.submit[j], j))

    def running_jobs(self) -> list[int]:
        return list(np.flatnonzero(self.status == RUNNING))

    def running_queue(self, n_preempt: int) -> list[int]:
        """Running job ids ordered by attained GPU-service desc (ties by
        id asc), the slots of the preemptive action space."""
        return sorted(self.running_jobs(),
                      key=lambda j: (-self.attained_service(j), j)
                      )[:n_preempt]

    def in_system(self) -> int:
        return int(((self.status == PENDING)
                    | (self.status == RUNNING)).sum())

    def done(self) -> bool:
        return bool((self.status[self.trace.valid] == DONE).all())

    def attained_service(self, j: int) -> float:
        """GPU-seconds of service attained (Tiresias' priority key)."""
        executed = float(self.trace.duration[j]) - float(self.remaining[j])
        return executed * float(self.trace.gpus[j])

    def jcts(self) -> np.ndarray:
        v = self.trace.valid & (self.status == DONE)
        return (self.finish[v] - self.trace.submit[v]).astype(np.float64)

    def avg_jct(self) -> float:
        j = self.jcts()
        return float(j.mean()) if len(j) else float("nan")

    def utilization(self) -> float:
        """Fraction of GPUs currently busy."""
        return 1.0 - float(self.free.sum()) / self.capacity

    def gpus_consistent(self) -> bool:
        """Conservation invariant: allocated + free == capacity, per node."""
        used = self.alloc.sum(axis=0)
        return bool((used + self.free == self.node_capacity).all())
