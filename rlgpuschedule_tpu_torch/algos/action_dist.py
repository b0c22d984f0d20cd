"""Masked-categorical action distribution (L4) of the port.

Counterpart of ``sample``, ``log_prob`` and ``entropy`` in the JAX
package's ``algos/action_dist.py``, for the single-head policies of
configs 1-4: ``logits`` is one ``[*B, A]`` tensor with infeasible
actions at -1e9. The pytree heads of the hierarchical policy wait for
the config-5 slice.
"""
from __future__ import annotations

import torch

_TINY = torch.finfo(torch.float32).tiny


def sample(generator: torch.Generator, logits: torch.Tensor,
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw one action per row by Gumbel-max, as ``jax.random.categorical``
    does: ``argmax(logits - log(-log u))`` with ``u`` uniform on
    ``[tiny, 1)``. ``generator`` lives on the logits' device. Returns
    (``i32[*B]`` actions, ``[*B]`` log-probabilities)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=logits.dtype)
    # rand draws from [0, 1); u = 0 would give a Gumbel of -inf
    gumbel = -torch.log(-torch.log(u.clamp_min_(_TINY)))
    actions = torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
    return actions, log_prob(logits, actions)


def log_prob(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Log-probability ``[*B]`` of ``actions`` (any integer dtype)."""
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, actions.long().unsqueeze(-1)).squeeze(-1)


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """Entropy ``[*B]`` of the masked categorical; masked entries
    (probability 0) contribute 0."""
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    return -torch.sum(p * torch.where(p > 0, logp, 0.0), dim=-1)
