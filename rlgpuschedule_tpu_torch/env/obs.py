"""Observation builders (L2) of the port: flat and occupancy grid.

Counterparts of ``queue_features``, ``flat_obs`` and ``grid_obs`` in the
JAX package's ``env/obs.py``, batched over the leading cluster axis.
The topology-graph observation waits for the config-4 slice.

Every division by a config constant is written as a product with its
reciprocal: jitted XLA computes it so, and so does torch's CUDA
division by a scalar, while torch's CPU kernel divides; written as a
product, the CPU and the card give the same bits."""
from __future__ import annotations

import torch

from ..sim.core import (RUNNING, SimParams, SimState, Trace, _take,
                        in_system, pending_queue, utilization)


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


def flat_obs(params: SimParams, state: SimState, trace: Trace,
             time_scale: float, queue: torch.Tensor | None = None,
             ) -> torch.Tensor:
    """``[E, N + 4K + 2]``: per-node free fraction, queue features (times
    tanh-squashed by ``time_scale``), utilization, normalized in-system
    count."""
    E = state.free.shape[0]
    free_frac = state.free.to(torch.float32) * (1.0 / params.gpus_per_node)
    qf = queue_features(params, state, trace, queue)
    qf = torch.cat([qf[:, :, :1], _tanh(qf[:, :, 1:3] * (1.0 / time_scale)),
                    qf[:, :, 3:]], dim=2)
    util = utilization(params, state)
    n_insys = in_system(state) * (1.0 / params.max_jobs)
    return torch.cat([free_frac, qf.reshape(E, -1),
                      torch.stack([util, n_insys], dim=1)], dim=1)


def grid_obs(params: SimParams, state: SimState, trace: Trace,
             time_scale: float, queue: torch.Tensor | None = None,
             ) -> torch.Tensor:
    """Occupancy image ``[E, N + K, G, 2]``.

    Cluster rows: ch0 = GPU slot occupied; ch1 = the remaining service
    (tanh-normalized) of the job holding the slot, slots sorted
    longest-remaining first within a node (a canonical waterfall).
    Queue rows: ch0 = demand bar (capped at G); ch1 = normalized service
    demand painted on the bar."""
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
    return torch.cat([cluster, qimg], dim=1)                   # [E, N+K, G, 2]
