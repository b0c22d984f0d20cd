"""Observation builders (L2) of the port: flat, occupancy grid and
topology graph.

Counterparts of ``node_health``, ``node_geometry``,
``queue_features``, ``run_features``, ``flat_obs``, ``grid_obs``,
``build_adjacency`` and ``graph_obs`` in the JAX package's
``env/obs.py``, batched over the leading cluster axis. Preemptive
configs (``preempt_len`` R > 0) append the R running-queue slots to
each observation; a fault or domain run's flat observation appends the
per-node health and geometry channels (:mod:`.env`).

Every division by a config constant is written as a product with its
reciprocal: jitted XLA computes it so, and so does torch's CUDA
division by a scalar, while torch's CPU kernel divides; written as a
product, the CPU and the card give the same bits."""
from __future__ import annotations

import numpy as np
import torch

from ..sim.core import (RUNNING, SimParams, SimState, Trace, _take,
                        in_system, pending_queue, running_queue,
                        utilization)
from ..sim.faults import FaultSchedule, node_up

GRAPH_FEATURES = 5


def node_health(params: SimParams, state: SimState,
                faults: FaultSchedule | None = None) -> torch.Tensor:
    """Per-node effective speed ``f32[E, N]``: 1 healthy, ``1/slowdown``
    straggling, 0 drained at the clock; every node healthy with
    ``faults=None`` (a fault-trained policy replayed on a clean
    cluster)."""
    if faults is None:
        return torch.ones_like(state.free, dtype=torch.float32)
    return torch.where(node_up(faults, state.clock),
                       torch.reciprocal(faults.slowdown), 0.0)


def node_geometry(params: SimParams, state: SimState,
                  faults=None) -> torch.Tensor:
    """Per-node capacity ``f32[E, N]``: usable GPUs / ``gpus_per_node``
    of a domain schedule, so a policy can tell a shrunken node from a
    busy one; a full homogeneous cluster without one."""
    cap = getattr(faults, "capacity", None)
    if cap is None:
        return torch.ones_like(state.free, dtype=torch.float32)
    return cap.to(torch.float32) * (1.0 / params.gpus_per_node)


def _tanh(x: torch.Tensor) -> torch.Tensor:
    """f32 ``tanh`` with the same bits on every device. An f32 tanh is
    not correctly rounded, and torch's CPU and CUDA kernels round some
    inputs differently; taken in f64 and rounded to f32 it is the
    correctly rounded value (but for about one input in 10^8), so a
    rollout replayed on the CPU sees the card's observations."""
    return torch.tanh(x.double()).to(x.dtype)


def queue_features(params: SimParams, state: SimState, trace: Trace,
                   queue: torch.Tensor | None = None) -> torch.Tensor:
    """Per-queue-slot features ``[E, K, 4]``: demand/capacity, waiting
    time, service demand (raw seconds), valid."""
    if queue is None:
        queue = pending_queue(params, state)               # [E, K]
    jc = queue.clamp(0, params.max_jobs - 1)
    occupied = queue >= 0
    valid = occupied.to(torch.float32)
    demand = (_take(trace.gpus, jc).to(torch.float32)
              * (1.0 / params.capacity) * valid)
    # where, not *valid: padding rows have submit=+inf, and
    # (clock - inf) * 0 would be NaN
    wait = torch.where(occupied,
                       state.clock[:, None] - _take(trace.submit, jc), 0.0)
    service = torch.where(occupied, _take(trace.duration, jc), 0.0)
    return torch.stack([demand, wait, service, valid], dim=2)


def run_features(params: SimParams, state: SimState, trace: Trace,
                 time_scale: float, run_queue: torch.Tensor | None = None,
                 ) -> torch.Tensor:
    """Per-preempt-slot features ``[E, R, 4]`` over the running queue
    (most attained GPU-service first): demand/capacity, executed and
    remaining seconds (tanh-squashed by ``time_scale``), valid."""
    if run_queue is None:
        run_queue = running_queue(params, state, trace)    # [E, R]
    jc = run_queue.clamp(0, params.max_jobs - 1)
    occupied = run_queue >= 0
    valid = occupied.to(torch.float32)
    demand = (_take(trace.gpus, jc).to(torch.float32)
              * (1.0 / params.capacity) * valid)
    rem = _take(state.remaining, jc)
    executed = torch.where(occupied, _take(trace.duration, jc) - rem, 0.0)
    remaining = torch.where(occupied, rem, 0.0)
    return torch.stack([demand, _tanh(executed * (1.0 / time_scale)),
                        _tanh(remaining * (1.0 / time_scale)), valid], dim=2)


def flat_obs(params: SimParams, state: SimState, trace: Trace,
             time_scale: float, queue: torch.Tensor | None = None,
             run_queue: torch.Tensor | None = None) -> torch.Tensor:
    """``[E, N + 4K + 4R + 2]``: per-node free fraction, queue features
    (times tanh-squashed by ``time_scale``), running-slot features
    (preemptive configs), utilization, normalized in-system count."""
    E = state.free.shape[0]
    free_frac = state.free.to(torch.float32) * (1.0 / params.gpus_per_node)
    qf = queue_features(params, state, trace, queue)
    qf = torch.cat([qf[:, :, :1], _tanh(qf[:, :, 1:3] * (1.0 / time_scale)),
                    qf[:, :, 3:]], dim=2)
    util = utilization(params, state)
    n_insys = in_system(state) * (1.0 / params.max_jobs)
    parts = [free_frac, qf.reshape(E, -1)]
    if params.preempt_len:
        parts.append(run_features(params, state, trace, time_scale,
                                  run_queue).reshape(E, -1))
    parts.append(torch.stack([util, n_insys], dim=1))
    return torch.cat(parts, dim=1)


def grid_obs(params: SimParams, state: SimState, trace: Trace,
             time_scale: float, queue: torch.Tensor | None = None,
             run_queue: torch.Tensor | None = None) -> torch.Tensor:
    """Occupancy image ``[E, N + K (+ R), G, 2]``.

    Cluster rows: ch0 = GPU slot occupied; ch1 = the remaining service
    (tanh-normalized) of the job holding the slot, slots sorted
    longest-remaining first within a node (a canonical waterfall).
    Queue rows: ch0 = demand bar (capped at G); ch1 = normalized service
    demand painted on the bar. Preempt rows (preemptive configs): ch0 =
    demand bar of the running slot's job; ch1 = its normalized remaining
    service on the bar."""
    N, G, J = params.n_nodes, params.gpus_per_node, params.max_jobs
    E = state.free.shape[0]
    dev = state.free.device
    used = (G - state.free).to(torch.float32)                  # [E, N]
    slots = torch.arange(G, dtype=torch.float32, device=dev)   # [G]
    occ = (slots < used[:, :, None]).to(torch.float32)         # [E, N, G]
    running = (state.status == RUNNING).to(torch.float32)
    val = running * _tanh(state.remaining * (1.0 / time_scale))   # [E, J]
    # stable, as jnp.argsort is: equal values keep row order
    order = torch.argsort(-val, dim=1, stable=True)            # [E, J]
    # slot s of node n belongs to the first job (longest remaining first)
    # whose cumulative GPU count on n exceeds s
    alloc_sorted = state.alloc.gather(1, order[:, :, None].expand(E, J, N))
    cum = torch.cumsum(alloc_sorted, 1, dtype=torch.int32)     # [E, J, N]
    sidx = torch.arange(G, dtype=torch.int32, device=dev)
    idx = torch.searchsorted(cum.transpose(1, 2).contiguous(),
                             sidx.expand(E, N, G).contiguous(),
                             right=True)                       # [E, N, G]
    rem_img = (_take(val.gather(1, order), idx.clamp(0, J - 1))
               * (idx < J))
    cluster = torch.stack([occ, occ * rem_img], dim=3)         # [E, N, G, 2]

    if queue is None:
        queue = pending_queue(params, state)
    jc = queue.clamp(0, J - 1)
    valid = (queue >= 0).to(torch.float32)
    demand = (torch.clamp_max(_take(trace.gpus, jc), G).to(torch.float32)
              * valid)
    bar = (slots < demand[:, :, None]).to(torch.float32)       # [E, K, G]
    service = (_tanh(_take(trace.duration, jc) * (1.0 / time_scale))
               * valid)
    qimg = torch.stack([bar, bar * service[:, :, None]], dim=3)
    parts = [cluster, qimg]
    if params.preempt_len:
        if run_queue is None:
            run_queue = running_queue(params, state, trace)
        rc = run_queue.clamp(0, J - 1)
        rvalid = (run_queue >= 0).to(torch.float32)
        rdemand = (torch.clamp_max(_take(trace.gpus, rc), G)
                   .to(torch.float32) * rvalid)
        rbar = (slots < rdemand[:, :, None]).to(torch.float32)  # [E, R, G]
        rrem = (_tanh(_take(state.remaining, rc) * (1.0 / time_scale))
                * rvalid)
        parts.append(torch.stack([rbar, rbar * rrem[:, :, None]], dim=3))
    return torch.cat(parts, dim=1)                       # [E, N+K+R, G, 2]


def build_adjacency(n_nodes: int, queue_len: int,
                    nodes_per_rack: int | None = None,
                    preempt_len: int = 0) -> np.ndarray:
    """Static topology adjacency ``f32[V, V]``, V = N + K + R: cluster
    nodes joined within a rack (all to all if ``nodes_per_rack`` is
    None), every queue slot and running slot joined to every cluster
    node, self-loops. The same array on every device; the policy holds
    it as a buffer."""
    V = n_nodes + queue_len + preempt_len
    a = np.zeros((V, V), np.float32)
    if nodes_per_rack is None:
        a[:n_nodes, :n_nodes] = 1.0
    else:
        for r0 in range(0, n_nodes, nodes_per_rack):
            r1 = min(r0 + nodes_per_rack, n_nodes)
            a[r0:r1, r0:r1] = 1.0
    a[:n_nodes, n_nodes:] = 1.0   # node <-> {queue, running} bipartite
    a[n_nodes:, :n_nodes] = 1.0
    np.fill_diagonal(a, 1.0)
    return a


def graph_obs(params: SimParams, state: SimState, trace: Trace,
              time_scale: float, queue: torch.Tensor | None = None,
              run_queue: torch.Tensor | None = None) -> torch.Tensor:
    """Node features ``[E, N + K (+ R), 5]`` over the static topology
    graph of :func:`build_adjacency`:

    - cluster rows: free fraction, used fraction, mean normalized
      remaining service per used GPU, 1, 0;
    - queue rows: demand/capacity, wait, service (tanh-squashed), 0,
      valid;
    - preempt rows: demand/capacity, executed, remaining, 0, 0.

    The per-node remaining-service sum is taken in f64 (its integer
    times f32 products are exact there) and rounded once, so the CPU
    and the card give the same bits whatever order they sum in."""
    G = params.gpus_per_node
    free_frac = state.free.to(torch.float32) * (1.0 / G)
    used = (G - state.free).to(torch.float32)
    running = (state.status == RUNNING).to(torch.float32)
    weight = running * _tanh(state.remaining * (1.0 / time_scale))  # [E, J]
    rem_n = (state.alloc.to(torch.float64)
             * weight.to(torch.float64)[:, :, None]).sum(1).to(torch.float32)
    rem_avg = rem_n / torch.clamp_min(used, 1.0)
    ones = torch.ones_like(free_frac)
    cluster = torch.stack([free_frac, 1.0 - free_frac, rem_avg, ones,
                           0.0 * ones], dim=2)                 # [E, N, 5]
    qf = queue_features(params, state, trace, queue)           # [E, K, 4]
    wait = _tanh(qf[:, :, 1] * (1.0 / time_scale))
    service = _tanh(qf[:, :, 2] * (1.0 / time_scale))
    zeros = torch.zeros_like(wait)
    parts = [cluster, torch.stack([qf[:, :, 0], wait, service, zeros,
                                   qf[:, :, 3]], dim=2)]
    if params.preempt_len:
        rf = run_features(params, state, trace, time_scale, run_queue)
        rzeros = torch.zeros_like(rf[:, :, 0])
        parts.append(torch.stack([rf[:, :, 0], rf[:, :, 1], rf[:, :, 2],
                                  rzeros, rzeros], dim=2))
    return torch.cat(parts, dim=1)                       # [E, N+K+R, 5]
