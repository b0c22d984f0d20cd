"""Generalized advantage estimation (L4 op) of the port.

Counterpart of ``compute_gae`` in the JAX package's ``ops/gae.py``,
which is a reverse ``lax.scan`` over time. Here it is a reverse Python
loop over ``T`` whose body is a few elementwise ops on ``[E]`` rows,
written in the scan body's order.

XLA contracts the recurrence ``delta + c * next_adv`` into one fused
multiply-add (one rounding). The port computes it the same way on every
device: the product of two f32 values is exact in f64, so the sum taken
in f64 and rounded to f32 is the fused result (up to a double rounding
that lands once in about 2^29 values). With separate f32 ops the
results part from XLA's by hundreds of ulp where the advantages cancel
to near zero.
"""
from __future__ import annotations

import torch


def compute_gae(rewards: torch.Tensor, values: torch.Tensor,
                dones: torch.Tensor, last_value: torch.Tensor,
                gamma: float, lam: float,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages, returns), each ``[T, ...]``.

    ``rewards``/``values``/``dones`` are ``[T, ...]``: the reward at each
    step, the value of the state the action was taken in, and whether the
    episode ended at this step (the next state then belongs to a fresh
    episode, so nothing is bootstrapped across). ``last_value`` is the
    value of the state after the final step."""
    dones = dones.to(rewards.dtype)
    advantages = torch.empty_like(rewards)
    next_adv = torch.zeros_like(last_value)
    next_v = last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterm = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_v * nonterm - values[t]
        c = gamma * lam * nonterm
        next_adv = torch.addcmul(delta.double(), c.double(),
                                 next_adv.double()).to(rewards.dtype)
        advantages[t] = next_adv
        next_v = values[t]
    return advantages, advantages + values
