"""Reward functions (L2) of the port: the JCT reward, the multi-tenant
fairness reward of config 3 and the anti-stall preemption charge.

Counterpart of ``reward_jct``, ``tenant_counts``, ``reward_fair`` and
``preempt_charge`` in the JAX package's ``env/rewards.py``."""
from __future__ import annotations

import torch

from ..sim.core import PENDING, RUNNING, SimState, StepInfo, Trace


def preempt_charge(info: StepInfo, preempt_cost: float) -> torch.Tensor:
    """-``preempt_cost`` per preemption and per re-placement (a placement
    of a job that ran before, possible only after a preemption). Both
    legs of a place<->preempt cycle cost no simulated time, so without
    the charge stalling the clock in such a cycle escapes the backlog
    penalty forever. First placements are never charged. On a
    non-preemptive action space without faults no job is placed twice
    and the charge is exactly -0.0, which leaves any reward's bits
    unchanged; a drain kills jobs back to the queue, and their
    re-placement is charged as JAX charges it."""
    replaced = info.placed & ~info.first_placed
    return -preempt_cost * (info.preempted | replaced).to(torch.float32)


def reward_jct(info: StepInfo, reward_scale: float,
               place_bonus: float = 0.0) -> torch.Tensor:
    """Exact JCT objective: sum of JCT = integral of n_in_system(t) dt, so
    accumulating ``-dt * n_in_system`` over decision intervals makes the
    undiscounted return equal -sum(JCT) / scale. ``place_bonus`` adds a
    telescoping shaping reward per first placement of a job."""
    # times the reciprocal, not divided by the scale: XLA rewrites a
    # division by a constant that way, and the reward stays bit-identical
    # to the JAX package's only if the port does the same
    base = (-(info.dt * info.in_system_before.to(torch.float32))
            * (1.0 / reward_scale))
    if place_bonus:
        return base + place_bonus * info.first_placed.to(torch.float32)
    return base


def tenant_counts(state: SimState, trace: Trace,
                  n_tenants: int) -> torch.Tensor:
    """In-system job count per tenant, ``[E, n_tenants]`` (f32). A tenant
    id outside ``[0, n_tenants)`` counts nowhere, as in JAX's one-hot."""
    insys = (state.status == PENDING) | (state.status == RUNNING)
    onehot = (trace.tenant[..., None] == torch.arange(
        n_tenants, device=trace.tenant.device)).to(torch.float32)
    return (onehot * insys[..., None].to(torch.float32)).sum(-2)


def reward_fair(state_before: SimState, trace: Trace, info: StepInfo,
                n_tenants: int, reward_scale: float) -> torch.Tensor:
    """Multi-tenant fairness: accumulate ``-dt * sum_t n_t^2`` (``n_t``
    tenant t's in-system count over the interval). For a fixed total
    backlog the sum of squares is least at equal shares, so backlog on
    one tenant costs more than the same backlog spread evenly."""
    n_t = tenant_counts(state_before, trace, n_tenants)
    # times the reciprocal, as in reward_jct
    return -(info.dt * (n_t * n_t).sum(-1)) * (1.0 / reward_scale)
