"""The greedy decision rule shared by replay and serving.

Counterpart of ``greedy_actions`` and ``policy_decision`` in the JAX
package's ``decision.py``: :func:`..eval.replay` and
:class:`..serve.engine.InferenceEngine` both decide through
:func:`policy_decision`, so a served action is the action replay would
take on the same observation. The preempt stall gate waits for the
preemption slice (there are no preempt actions to gate here)."""
from __future__ import annotations

import torch
from torch import nn


def greedy_actions(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis (first index on ties, as jnp.argmax)."""
    return torch.argmax(logits, dim=-1)


def policy_decision(policy: nn.Module, obs: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """The deterministic decision: masked logits -> greedy actions."""
    logits, _ = policy(obs, mask)
    return greedy_actions(logits)
