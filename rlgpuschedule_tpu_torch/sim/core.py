"""Batched cluster simulator (L1), the device hot path of the port.

The PyTorch counterpart of the JAX package's ``sim/core.py``. Every
function takes and returns tensors with a leading cluster axis ``E``:
the JAX package writes per-cluster functions and ``vmap``s them, the
port writes the batch into each function. State is a tuple of
fixed-shape tensors: a job table ``[E, J]`` with status codes, a
per-job allocation ``[E, J, N]``, a free-GPU vector ``[E, N]`` and a
clock ``[E]``. The event queue is a masked min over next-event times;
every outcome of a step is computed and then selected with
``torch.where``, so a step has no data-dependent host control flow.

dtypes are the JAX package's: i32 for counts and codes, f32 for time.
On integer-valued traces the state after every step is bit-identical
to the JAX package's (``tests/test_torch_sim.py``).

The action space is the JAX package's ``[K*P placements][R
preemptions][no-op]``: pack or pack|spread placement (``n_placements``
1 or 2) and an optional preempt block (``preempt_len``). With
``n_placements == 1`` and ``preempt_len == 0`` the step computes no
spread placement and no preemption, as JAX drops them at trace time.

``faults`` (a batched :class:`.faults.FaultSchedule`, or a
:class:`..domains.DomainSchedule` with its per-node capacity) threads the
cluster fault process through placement, event selection, progress
and drain kills. With ``faults=None`` none of that arithmetic is issued:
the step is the fault-free one, op for op.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..traces.records import ArrayTrace
from .faults import (FaultSchedule, effective_free, job_stretch,
                     next_transition, node_up, validate_fault_schedule)
# job status codes and placement modes, shared with the oracle
from .oracle import DONE, NOT_ARRIVED, PACK, PENDING, RUNNING, SPREAD

INF = float("inf")
_EPS = 1e-5  # completion tolerance in float32 virtual time


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Static simulator configuration."""
    n_nodes: int
    gpus_per_node: int
    max_jobs: int          # J: rows in the (padded) job table
    queue_len: int = 16    # K: pending-queue slots visible to the agent
    n_placements: int = 1  # P: 1 = pack only; 2 = pack|spread
    preempt_len: int = 0   # R: running-job slots the agent may preempt

    @property
    def capacity(self) -> int:
        return self.n_nodes * self.gpus_per_node

    @property
    def n_actions(self) -> int:
        # [K*P placements][R preemptions][no-op]; see rl_step
        return self.queue_len * self.n_placements + self.preempt_len + 1


def validate_trace(params: SimParams, tr: ArrayTrace,
                   clamp: bool = False,
                   faults: "FaultSchedule | None" = None) -> ArrayTrace:
    """A valid job demanding more GPUs than the cluster has can never be
    placed; in the simulator that shows only as an episode that never
    ends. Raise here instead, or with ``clamp=True`` cap demands at
    capacity. ``faults`` (one host schedule) is checked against the
    cluster at the same point (:func:`.faults.validate_fault_schedule`)."""
    if faults is not None:
        validate_fault_schedule(params.n_nodes, faults)
    over = tr.valid & (tr.gpus > params.capacity)
    if not over.any():
        return tr
    if not clamp:
        raise ValueError(
            f"{int(over.sum())} job(s) demand more than the cluster's "
            f"{params.capacity} GPUs (max demand "
            f"{int(tr.gpus[tr.valid].max())}); pass clamp=True to cap "
            f"demands at capacity")
    return dataclasses.replace(tr, gpus=np.minimum(tr.gpus, params.capacity))


class Trace(NamedTuple):
    """Device-side traces of E clusters (rows sorted by submit; padding
    has submit=+inf)."""
    submit: torch.Tensor    # f32[E, J]
    duration: torch.Tensor  # f32[E, J]
    gpus: torch.Tensor      # i32[E, J]
    tenant: torch.Tensor    # i32[E, J]
    valid: torch.Tensor     # bool[E, J]

    @staticmethod
    def from_array_traces(traces: Sequence[ArrayTrace],
                          params: SimParams,
                          device: "torch.device | str | None" = None,
                          ) -> "Trace":
        """Stack host traces (all of one ``max_jobs``), check their gang
        sizes against capacity (:func:`validate_trace`) and upload
        them."""
        dev = resolve_device(device)
        traces = [validate_trace(params, t) for t in traces]
        cols = [np.stack([getattr(t, f) for t in traces])
                for f in Trace._fields]
        return Trace(*(torch.from_numpy(c).to(dev) for c in cols))


class SimState(NamedTuple):
    """Dynamic simulator state of E clusters."""
    clock: torch.Tensor      # f32[E]
    status: torch.Tensor     # i32[E, J]
    remaining: torch.Tensor  # f32[E, J]
    start: torch.Tensor      # f32[E, J] (+inf until started)
    finish: torch.Tensor     # f32[E, J] (+inf until done)
    alloc: torch.Tensor      # i32[E, J, N]
    free: torch.Tensor       # i32[E, N]


class StepInfo(NamedTuple):
    """Per-step outcomes consumed by rewards and metrics, each ``[E]``."""
    placed: torch.Tensor            # bool: a job was placed this step
    dt: torch.Tensor                # f32: simulated time advanced
    in_system_before: torch.Tensor  # i32: arrived-not-done during [t, t+dt)
    done: torch.Tensor              # bool: all valid jobs DONE
    preempted: torch.Tensor         # bool: a running job was preempted
    first_placed: torch.Tensor      # bool: placed a job that never ran


def select(cond: torch.Tensor, a, b):
    """``cond ? a : b`` per cluster over (nested) tuples and dicts of
    tensors; ``cond`` is ``bool[E]`` and broadcasts over each leaf's
    trailing axes."""
    if isinstance(a, tuple):
        return type(a)(*(select(cond, x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return {k: select(cond, a[k], b[k]) for k in a}
    c = cond.reshape(cond.shape + (1,) * (a.ndim - cond.ndim))
    return torch.where(c, a, b)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[e, idx[e, ...]]`` for ``x`` of shape ``[E, J]``."""
    flat = idx.reshape(idx.shape[0], -1).long()
    return x.gather(1, flat).reshape(idx.shape)


def _stretched_eta(clock: torch.Tensor, remaining: torch.Tensor,
                   stretch: torch.Tensor) -> torch.Tensor:
    """``clock + remaining * stretch`` per job, ``f32[E, J]``, rounded
    once as the fused multiply-add XLA contracts it to: the f32 product
    is exact in f64, so the f64 sum rounds to the same f32 on the CPU
    and the card."""
    return (clock[:, None].double()
            + remaining.double() * stretch.double()).float()


def _spacing(t: torch.Tensor) -> torch.Tensor:
    """``jnp.spacing`` for ``t >= 0``: the gap to the next larger f32.
    NaN at ``+inf``, as there."""
    return torch.nextafter(t, torch.full_like(t, INF)) - t


# ---- lifecycle --------------------------------------------------------------

def init_state(params: SimParams, trace: Trace,
               faults: "FaultSchedule | None" = None) -> SimState:
    """Every cluster at clock 0 with its arrivals processed. A domain
    schedule's per-node ``capacity`` is the initial free vector; a plain
    fault schedule (or none) keeps the full static cluster."""
    E, J = trace.submit.shape
    N = params.n_nodes
    dev = trace.submit.device
    cap = getattr(faults, "capacity", None)
    free = (torch.full((E, N), params.gpus_per_node, dtype=torch.int32,
                       device=dev) if cap is None
            else cap.to(torch.int32).clone())
    state = SimState(
        clock=torch.zeros(E, dtype=torch.float32, device=dev),
        status=torch.where(trace.valid, NOT_ARRIVED, DONE).to(torch.int32),
        remaining=trace.duration.clone(),
        start=torch.full((E, J), INF, dtype=torch.float32, device=dev),
        finish=torch.full((E, J), INF, dtype=torch.float32, device=dev),
        alloc=torch.zeros(E, J, N, dtype=torch.int32, device=dev),
        free=free,
    )
    return _process_arrivals(state, trace)


def _process_arrivals(state: SimState, trace: Trace) -> SimState:
    arrived = ((state.status == NOT_ARRIVED)
               & (trace.submit <= state.clock[:, None]))
    return state._replace(status=torch.where(arrived, PENDING, state.status))


# ---- events -----------------------------------------------------------------

def next_event_time(state: SimState, trace: Trace,
                    faults: "FaultSchedule | None" = None) -> torch.Tensor:
    """Earliest future arrival or completion per cluster, ``+inf`` if none
    (a masked min in place of a priority queue). With ``faults`` a
    completion is stretched (``clock + remaining * stretch``) and every
    drain start and node return is an event too."""
    arrival = torch.where(state.status == NOT_ARRIVED, trace.submit,
                          INF).amin(1)
    if faults is None:
        eta = state.clock[:, None] + state.remaining
    else:
        eta = _stretched_eta(state.clock, state.remaining,
                             job_stretch(faults, state.alloc))
    completion = torch.where(state.status == RUNNING, eta, INF).amin(1)
    t = torch.minimum(arrival, completion)
    if faults is not None:
        t = torch.minimum(t, next_transition(faults, state.clock))
    return t


def advance_to(state: SimState, trace: Trace, t: torch.Tensor,
               faults: "FaultSchedule | None" = None) -> SimState:
    """Advance each clock to ``t`` (the caller guarantees t <= next event;
    ``+inf`` leaves the clock where it is). Completions at ``t`` are
    processed before arrivals.

    With ``faults`` running work progresses at ``1 / stretch``, and after
    the completions, before the arrivals, every job holding GPUs on a
    node that is down at ``t`` goes back to PENDING with its attained
    service kept (:func:`_kill_drained`). Transitions are events, so
    ``t`` never lies beyond one."""
    t = torch.where(torch.isfinite(t), t, state.clock)
    dt = t - state.clock
    running = state.status == RUNNING
    if faults is None:
        progressed = state.remaining - dt[:, None]
        eta = state.clock[:, None] + state.remaining
    else:
        stretch = job_stretch(faults, state.alloc)
        progressed = state.remaining - dt[:, None] / stretch
        eta = _stretched_eta(state.clock, state.remaining, stretch)
    remaining = torch.where(running, torch.clamp_min(progressed, 0.0),
                            state.remaining)
    # Completion is tested on absolute time with a tolerance of a few
    # ulps of t: at large clocks the f32 spacing of clock + remaining is
    # wider than any absolute epsilon, so remaining - dt can stay a small
    # positive number while next_event_time rounds to the current clock
    # (a dt = 0 deadlock). An absolute epsilon scaled to Philly clocks
    # would instead complete jobs seconds early.
    tol = _EPS + 4.0 * _spacing(t)
    completed = running & (eta <= (t + tol)[:, None])
    released = (state.alloc * completed[:, :, None]).sum(1, dtype=torch.int32)
    state = SimState(
        clock=t,
        status=torch.where(completed, DONE, state.status),
        remaining=torch.where(completed, 0.0, remaining),
        start=state.start,
        finish=torch.where(completed, t[:, None], state.finish),
        alloc=torch.where(completed[:, :, None], 0, state.alloc),
        free=state.free + released,
    )
    if faults is not None:
        state = _kill_drained(state, faults)
    return _process_arrivals(state, trace)


def _kill_drained(state: SimState, faults: FaultSchedule) -> SimState:
    """RUNNING -> PENDING for every job holding GPUs on a node that is
    down at the clock; the GPUs go back to ``free``, so ``free +
    allocated == capacity`` per node at every instant. Idempotent: a
    killed job holds nothing, so a later step while the node is still
    down changes nothing."""
    up = node_up(faults, state.clock)                          # [E, N]
    killed = (state.status == RUNNING) & (
        (state.alloc > 0) & ~up[:, None, :]).any(2)
    released = (state.alloc * killed[:, :, None]).sum(1, dtype=torch.int32)
    return state._replace(
        status=torch.where(killed, PENDING, state.status),
        alloc=torch.where(killed[:, :, None], 0, state.alloc),
        free=state.free + released)


# ---- placement -------------------------------------------------------------

def pack_placement(free: torch.Tensor, demand: torch.Tensor,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fill the freest nodes first, ties to the lowest node id. ``free``
    is ``i32[E, N]``, ``demand`` ``i32[E]``; returns (``alloc[E, N]``,
    ``feasible[E]``). The sort must be stable to give the oracle's
    (free desc, id asc) order: ``torch.argsort`` is not stable unless
    asked, and on CUDA not even deterministic."""
    feasible = demand <= free.sum(1, dtype=torch.int32)
    order = torch.argsort(-free, dim=1, stable=True)
    sorted_free = free.gather(1, order)
    before = torch.cumsum(sorted_free, 1, dtype=torch.int32) - sorted_free
    take = torch.minimum(torch.clamp_min(demand[:, None] - before, 0),
                         sorted_free)
    alloc = torch.zeros_like(free).scatter(1, order, take)
    return torch.where(feasible[:, None], alloc, 0), feasible


def spread_placement(free: torch.Tensor, demand: torch.Tensor,
                     gpus_per_node: int,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Water-filling: the smallest level ``t`` with sum(min(free, t)) >=
    demand; the excess is trimmed from the highest node ids allocated
    exactly ``t``. Shapes as :func:`pack_placement`."""
    feasible = demand <= free.sum(1, dtype=torch.int32)
    levels = torch.arange(gpus_per_node + 1, dtype=torch.int32,
                          device=free.device)                      # [G+1]
    supply = torch.minimum(free[:, None, :], levels[None, :, None]
                           ).sum(2, dtype=torch.int32)             # [E, G+1]
    # the first level that suffices; argmax over an integer cast, since
    # torch's argmax does not take bool everywhere
    t = torch.argmax((supply >= demand[:, None]).to(torch.int32), dim=1
                     ).to(torch.int32)
    alloc = torch.minimum(free, t[:, None])
    excess = alloc.sum(1, dtype=torch.int32) - demand
    at_t = alloc == t[:, None]
    # rank 1.. from the highest node id among the nodes at level t
    rank_from_top = torch.flip(torch.cumsum(
        torch.flip(at_t, [1]).to(torch.int32), 1, dtype=torch.int32), [1])
    trim = at_t & (rank_from_top <= excess[:, None])
    alloc = torch.where(trim, alloc - 1, alloc)
    return torch.where(feasible[:, None], alloc, 0), feasible


def placement(free: torch.Tensor, demand: torch.Tensor,
              mode: torch.Tensor | None, gpus_per_node: int,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack (mode 0) or spread (mode 1) per cluster; ``mode=None`` packs
    every cluster and computes no spread placement at all (the
    pack-only action space, and the forced placement of the queue
    head)."""
    pa, pf = pack_placement(free, demand)
    if mode is None:
        return pa, pf
    sa, sf = spread_placement(free, demand, gpus_per_node)
    spread = mode == SPREAD
    return torch.where(spread[:, None], sa, pa), torch.where(spread, sf, pf)


# ---- scheduling actions -----------------------------------------------------

def try_place(params: SimParams, state: SimState, trace: Trace,
              j: torch.Tensor, mode: torch.Tensor | None,
              faults: "FaultSchedule | None" = None,
              ) -> tuple[SimState, torch.Tensor]:
    """Gang-place job row ``j[e]`` in each cluster (-1 = none) with
    placement ``mode[e]`` (``None``: pack). Returns (state',
    success[E]). All or nothing: where it does not fit, that cluster's
    state is unchanged. With ``faults`` a drained node offers no GPUs
    (:func:`.faults.effective_free`), so no gang lands on one."""
    J = params.max_jobs
    jc = j.clamp(0, J - 1)
    pending = (j >= 0) & (_take(state.status, jc) == PENDING)
    demand = _take(trace.gpus, jc)
    free = effective_free(faults, state.free, state.clock)
    alloc, feasible = placement(free, demand, mode, params.gpus_per_node)
    ok = pending & feasible
    allocd = torch.where(ok[:, None], alloc, 0)
    rows = torch.arange(J, device=j.device)
    row = (rows[None, :] == jc[:, None]) & ok[:, None]          # [E, J]
    return SimState(
        clock=state.clock,
        status=torch.where(row, RUNNING, state.status),
        remaining=state.remaining,
        start=torch.where(row, torch.minimum(state.start,
                                             state.clock[:, None]),
                          state.start),
        finish=state.finish,
        alloc=state.alloc + row[:, :, None].to(torch.int32)
        * allocd[:, None, :],
        free=state.free - allocd,
    ), ok


def preempt(state: SimState, j: torch.Tensor, max_jobs: int,
            ) -> tuple[SimState, torch.Tensor]:
    """RUNNING -> PENDING for job row ``j[e]`` (-1 = none); the attained
    service is kept. Returns (state', success[E])."""
    jc = j.clamp(0, max_jobs - 1)
    ok = (j >= 0) & (_take(state.status, jc) == RUNNING)
    rows = torch.arange(max_jobs, device=j.device)
    row = (rows[None, :] == jc[:, None]) & ok[:, None]          # [E, J]
    released = (state.alloc * row[:, :, None]).sum(1, dtype=torch.int32)
    return state._replace(
        status=torch.where(row, PENDING, state.status),
        alloc=torch.where(row[:, :, None], 0, state.alloc),
        free=state.free + released,
    ), ok


# ---- queue & queries --------------------------------------------------------

def pending_queue(params: SimParams, state: SimState) -> torch.Tensor:
    """Row indices of the first K pending jobs, -1 padded: ``i32[E, K]``.
    Trace rows are submit-sorted, so row order is the queue order."""
    K = params.queue_len
    E, J = state.status.shape
    pending = state.status == PENDING
    rank = torch.cumsum(pending.to(torch.int32), 1, dtype=torch.int32) - 1
    sel = pending & (rank < K)
    target = torch.where(sel, rank, K).long()      # K = the drop slot
    rows = torch.arange(J, dtype=torch.int32, device=rank.device)
    src = torch.where(sel, rows[None, :], -1)
    # Every row not among the first K writes slot K, which is cut off
    # below. CUDA picks an arbitrary one of those writes, and that is
    # harmless: they all write -1, and the slot is discarded anyway.
    out = torch.full((E, K + 1), -1, dtype=torch.int32, device=rank.device)
    return out.scatter_(1, target, src)[:, :K]


def running_queue(params: SimParams, state: SimState, trace: Trace,
                  ) -> torch.Tensor:
    """Row indices of the R running jobs with the most attained
    GPU-service (ties to the lower row), -1 padded: ``i32[E, R]``, the
    slots the preempt actions index. The sort key is f32, where the
    oracle sorts in f64, so the two agree on integer-valued traces
    (exact in f32), not on every float trace."""
    R = params.preempt_len
    running = state.status == RUNNING
    key = torch.where(running, attained_service(state, trace), -INF)
    order = torch.argsort(-key, dim=1, stable=True)
    rows = order[:, :R].to(torch.int32)
    return torch.where(_take(running, rows), rows, -1)


def in_system(state: SimState) -> torch.Tensor:
    return ((state.status == PENDING)
            | (state.status == RUNNING)).sum(1, dtype=torch.int32)


def all_done(state: SimState, trace: Trace) -> torch.Tensor:
    return torch.where(trace.valid, state.status == DONE, True).all(1)


def attained_service(state: SimState, trace: Trace) -> torch.Tensor:
    """Per-job attained GPU-seconds ``f32[E, J]`` (Tiresias' key)."""
    return (trace.duration - state.remaining) * trace.gpus.to(torch.float32)


def action_mask(params: SimParams, state: SimState, trace: Trace,
                queue: torch.Tensor | None = None,
                run_queue: torch.Tensor | None = None,
                faults: "FaultSchedule | None" = None) -> torch.Tensor:
    """``bool[E, n_actions]``: a queue slot's placements are valid iff
    it holds a pending job whose gang fits in the free GPUs (pack and
    spread share feasibility); a preempt slot iff it holds a running
    job; no-op always. Pass a precomputed :func:`pending_queue` and
    :func:`running_queue` to share them with the observation builder.
    With ``faults`` only up nodes' GPUs count, so the mask and
    :func:`try_place` agree on what fits."""
    if queue is None:
        queue = pending_queue(params, state)                   # [E, K]
    demand = _take(trace.gpus, queue.clamp(0, params.max_jobs - 1))
    free = effective_free(faults, state.free, state.clock)
    ok = (queue >= 0) & (demand <= free.sum(1, dtype=torch.int32)[:, None])
    if params.n_placements > 1:
        # each slot's flag once per placement, as jnp.repeat repeats
        ok = torch.repeat_interleave(ok, params.n_placements, dim=1)
    parts = [ok]
    if params.preempt_len:
        if run_queue is None:
            run_queue = running_queue(params, state, trace)    # [E, R]
        parts.append(run_queue >= 0)
    parts.append(torch.ones(ok.shape[0], 1, dtype=torch.bool,
                            device=ok.device))
    return torch.cat(parts, 1)


# ---- the RL decision-point step --------------------------------------------

def rl_step(params: SimParams, state: SimState, trace: Trace,
            action: torch.Tensor,
            faults: "FaultSchedule | None" = None,
            ) -> tuple[SimState, StepInfo]:
    """One decision-point step of every cluster; the batched counterpart
    of the JAX package's ``rl_step``. Action layout: ``[K*P placements]
    [R preemptions][no-op]``; placement ``a`` takes queue slot ``a // P``
    with mode ``a % P``, preemption ``K*P + r`` running slot ``r``. A
    placement or a preemption costs no simulated time; a no-op (or one
    that fails) advances to the next event, or, when no event is left,
    force-places the queue head (pack). Every outcome is computed and
    the right one selected per cluster. ``faults`` (batched, or None for
    a healthy cluster) reaches placement, the event choice, progress and
    the drain kills; under it an exhausted event horizon means no
    transition is pending, so a node still down stays down, and a head
    that no longer fits makes the forced placement fail."""
    K, P, R, J = (params.queue_len, params.n_placements,
                  params.preempt_len, params.max_jobs)
    n_place = K * P
    queue = pending_queue(params, state)
    is_place = action < n_place
    if P == 1:
        k, mode = action.clamp(0, K - 1), None
    else:
        k, mode = (action // P).clamp(0, K - 1), action % P
    j = torch.where(is_place, _take(queue, k), -1)

    placed_state, placed = try_place(params, state, trace, j, mode, faults)
    progress = placed
    if R:
        run_q = running_queue(params, state, trace)
        is_pre = ~is_place & (action < n_place + R)
        r = (action - n_place).clamp(0, R - 1)
        pre_state, preempted = preempt(
            state, torch.where(is_pre, _take(run_q, r), -1), J)
        progress = placed | preempted

    t_next = next_event_time(state, trace, faults)
    has_event = torch.isfinite(t_next)
    n_before = in_system(state)
    advanced_state = advance_to(state, trace, t_next, faults)
    forced_state, forced_ok = try_place(params, state, trace, queue[:, 0],
                                        None, faults)

    waited = select(has_event, advanced_state, forced_state)
    if R:
        waited = select(preempted, pre_state, waited)
    new_state = select(placed, placed_state, waited)
    dt = torch.where(progress | ~has_event, 0.0, t_next - state.clock)
    # "first" = the job had never run before this step (start still +inf;
    # a re-placement keeps the first start)
    never_ran = ~torch.isfinite(state.start)
    first_sel = _take(never_ran, j.clamp(0, J - 1))
    first_head = _take(never_ran, queue[:, 0].clamp(0, J - 1))
    forced_fire = ~progress & ~has_event & forced_ok
    info = StepInfo(placed=placed | forced_fire,
                    dt=dt, in_system_before=n_before,
                    done=all_done(new_state, trace),
                    preempted=preempted if R else torch.zeros_like(placed),
                    first_placed=(placed & first_sel)
                    | (forced_fire & first_head))
    return new_state, info


# ---- metrics ----------------------------------------------------------------

def jct_stats(state: SimState, trace: Trace) -> dict[str, torch.Tensor]:
    """Avg/max JCT over completed valid jobs, per cluster."""
    done = trace.valid & (state.status == DONE)
    jct = torch.where(done, state.finish - trace.submit, 0.0)
    n_done = done.sum(1, dtype=torch.int32)
    return {"avg_jct": jct.sum(1) / torch.clamp_min(n_done, 1),
            "max_jct": torch.where(done, jct, -INF).amax(1),
            "n_done": n_done}


def utilization(params: SimParams, state: SimState) -> torch.Tensor:
    # the reciprocal's product, as jitted XLA and torch's CUDA divide
    return 1.0 - (state.free.sum(1, dtype=torch.int32)
                  * (1.0 / params.capacity))
