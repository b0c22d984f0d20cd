"""Reward functions (L2) of the port: the JCT reward and the anti-stall
preemption charge.

Counterpart of ``reward_jct`` and ``preempt_charge`` in the JAX
package's ``env/rewards.py``. The multi-tenant fairness reward waits
for the config-3 slice."""
from __future__ import annotations

import torch

from ..sim.core import StepInfo


def preempt_charge(info: StepInfo, preempt_cost: float) -> torch.Tensor:
    """-``preempt_cost`` per preemption and per re-placement (a placement
    of a job that ran before, possible only after a preemption). Both
    legs of a place<->preempt cycle cost no simulated time, so without
    the charge stalling the clock in such a cycle escapes the backlog
    penalty forever. First placements are never charged. On a
    non-preemptive action space no job is placed twice and the charge is
    exactly -0.0, which leaves any reward's bits unchanged."""
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
