"""Masked-categorical action distribution (L4) of the port.

Counterpart of ``sample``, ``log_prob`` and ``entropy`` in the JAX
package's ``algos/action_dist.py``. ``logits`` is one ``[*B, A]``
tensor with infeasible actions at -1e9 (the single-head policies of
configs 1-4), or a dict of such tensors (the hierarchical policy of
config 5: ``{"top": [*B, P+1], "pods": [*B, P, A]}``). A leaf may carry
axes between the batch and ``A``; each slice along them is an
independent head, and the joint log-probability and entropy sum them
away. The batch rank is the smallest leaf rank less one, JAX's
``_sum_heads`` rule.
"""
from __future__ import annotations

from typing import Any

import torch

_TINY = torch.finfo(torch.float32).tiny


def _sum_heads(per_head: dict) -> torch.Tensor:
    """Per-head values ``[*B, *heads]`` of a dict of heads reduced to the
    joint ``[*B]``: the batch rank is the minimum leaf rank, the extra
    trailing axes are stacked heads and are summed, and the heads are
    added in key order."""
    leaves = list(per_head.values())
    batch_ndim = min(x.ndim for x in leaves)
    total = 0
    for x in leaves:
        if x.ndim > batch_ndim:
            x = x.sum(tuple(range(batch_ndim, x.ndim)))
        total = total + x
    return total


def _gumbel_argmax(generator: torch.Generator,
                   logits: torch.Tensor) -> torch.Tensor:
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=logits.dtype)
    # rand draws from [0, 1); u = 0 would give a Gumbel of -inf
    gumbel = -torch.log(-torch.log(u.clamp_min_(_TINY)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def sample(generator: torch.Generator, logits: Any) -> tuple[Any, torch.Tensor]:
    """Draw one action per head by Gumbel-max, as ``jax.random.categorical``
    does: ``argmax(logits - log(-log u))`` with ``u`` uniform on
    ``[tiny, 1)``. ``generator`` lives on the logits' device; a dict's
    heads draw from it one after another in key order. Returns (``i32``
    actions of the logits' structure, ``[*B]`` joint log-probabilities)."""
    if isinstance(logits, dict):
        actions = {k: _gumbel_argmax(generator, v) for k, v in logits.items()}
    else:
        actions = _gumbel_argmax(generator, logits)
    return actions, log_prob(logits, actions)


def _head_log_prob(logits: torch.Tensor, actions: torch.Tensor
                   ) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, actions.long().unsqueeze(-1)).squeeze(-1)


def log_prob(logits: Any, actions: Any) -> torch.Tensor:
    """Joint log-probability ``[*B]`` of ``actions`` (any integer dtype,
    the logits' structure)."""
    if isinstance(logits, dict):
        return _sum_heads({k: _head_log_prob(v, actions[k])
                           for k, v in logits.items()})
    return _head_log_prob(logits, actions)


def _head_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    return -torch.sum(p * torch.where(p > 0, logp, 0.0), dim=-1)


def entropy(logits: Any) -> torch.Tensor:
    """Joint entropy ``[*B]`` of the masked categorical heads (their sum:
    the heads are independent); masked entries (probability 0)
    contribute 0."""
    if isinstance(logits, dict):
        return _sum_heads({k: _head_entropy(v) for k, v in logits.items()})
    return _head_entropy(logits)
