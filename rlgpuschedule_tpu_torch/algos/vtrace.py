"""V-trace off-policy correction (L4 op) of the port.

Counterpart of ``importance_ratios`` and ``compute_vtrace`` in the JAX
package's ``algos/vtrace.py``: IMPALA-style importance-weighted value
targets in the lambda-generalized form, a reverse recurrence over time
with the shapes of :func:`..ops.gae.compute_gae`. The advantage handed
to the surrogate loss is ``vs_t - V_t``, the accumulated form that
reduces to GAE when the data is on-policy.

As in :mod:`..ops.gae`, the recurrence ``delta + coef * next_acc`` is
taken in f64 and rounded once: XLA contracts it into a fused
multiply-add. With ``rho`` identically 1.0 every extra product below is
by the identity and the body is :func:`..ops.gae.compute_gae`'s, bit for
bit.
"""
from __future__ import annotations

import torch


def importance_ratios(behavior_log_prob: torch.Tensor,
                      target_log_prob: torch.Tensor) -> torch.Tensor:
    """pi_target(a|s) / pi_behavior(a|s) from the joint action
    log-probs; exactly 1.0 where the two are bitwise equal."""
    return torch.exp(target_log_prob - behavior_log_prob)


def compute_vtrace(rewards: torch.Tensor, values: torch.Tensor,
                   dones: torch.Tensor, last_value: torch.Tensor,
                   rho: torch.Tensor, gamma: float, lam: float,
                   rho_bar: float = 1.0, c_bar: float = 1.0,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages, returns), each ``[T, ...]``.

    ``rewards``/``values``/``dones`` as in :func:`..ops.gae.compute_gae`;
    ``rho`` ``[T, ...]`` holds the unclipped importance ratios of the
    taken actions (:func:`importance_ratios`). ``rho_bar`` clips the
    TD-error weight ``min(rho_bar, rho)``, ``c_bar`` the trace
    coefficient ``lam * min(c_bar, rho)``."""
    rho_clipped = torch.clamp_max(rho, rho_bar)
    c_clipped = torch.clamp_max(rho, c_bar)
    dones = dones.to(rewards.dtype)
    advantages = torch.empty_like(rewards)
    next_acc = torch.zeros_like(last_value)
    next_v = last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterm = 1.0 - dones[t]
        delta = rho_clipped[t] * (rewards[t] + gamma * next_v * nonterm
                                  - values[t])
        coef = gamma * lam * nonterm * c_clipped[t]
        next_acc = torch.addcmul(delta.double(), coef.double(),
                                 next_acc.double()).to(rewards.dtype)
        advantages[t] = next_acc
        next_v = values[t]
    return advantages, advantages + values
