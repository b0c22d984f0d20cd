"""Reward functions (L2) of the port: the JCT reward.

Counterpart of the JAX package's ``env/rewards.py``. The multi-tenant
fairness reward waits for the config-3 slice; the anti-stall preemption
charge waits for the preemption slice (it is zero on a non-preemptive
action space, where no job is ever placed twice)."""
from __future__ import annotations

import torch

from ..sim.core import StepInfo


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
