"""The greedy decision rule shared by replay and serving, and the
preempt stall gate.

Counterpart of ``preempt_slice``, ``stall_threshold``, ``gate_stalled``,
``greedy_actions``, ``policy_decision`` and ``policy_decision_full`` in
the JAX package's ``decision.py``: :func:`..eval.replay` and
:class:`..serve.engine.InferenceEngine` both decide through
:func:`policy_decision` and gate through :func:`gate_stalled`, so a
served action is the action replay would take on the same observation
and stall count; the engine's capture mode and the flywheel's canary
decide through :func:`policy_decision_full`, the same rule with the
behavior record beside it."""
from __future__ import annotations

import torch
from torch import nn


def preempt_slice(env_params, device: "torch.device | str | None" = None,
                  ) -> torch.Tensor | None:
    """``bool[n_actions]`` on ``device`` marking the preempt actions, or
    None if the action space has none (the stall gate is then a no-op,
    as on the hierarchical env, whose pods cannot preempt). Built once
    by the caller, never per step."""
    sim = getattr(env_params, "sim", None)
    if sim is None:
        return None
    if not sim.preempt_len:
        return None
    kp = sim.queue_len * sim.n_placements
    pre = torch.zeros(sim.n_actions, dtype=torch.bool, device=device)
    pre[kp:kp + sim.preempt_len] = True
    return pre


def stall_threshold(env_params) -> int:
    """Upper bound on legitimate consecutive zero-dt decision steps: at
    one instant a policy can place at most ``queue_len`` distinct
    pending jobs and rearrange at most ``preempt_len`` running ones;
    more than that is a place<->preempt cycle. The +4 is slack."""
    sim = env_params.sim
    return sim.queue_len + sim.preempt_len + 4


def gate_stalled(mask: torch.Tensor, stall: torch.Tensor, thresh: int,
                 pre: torch.Tensor) -> torch.Tensor:
    """Mask the preempt actions (``pre``, :func:`preempt_slice`) of every
    row whose count of consecutive zero-dt steps ``stall`` (``i32[E]``)
    has reached ``thresh``; ``mask`` is ``bool[E, A]``."""
    return mask & ~((stall >= thresh)[:, None] & pre)


def greedy_actions(logits):
    """Argmax over the last axis (first index on ties, as jnp.argmax),
    per head of a dict of logits."""
    if isinstance(logits, dict):
        return {k: torch.argmax(v, dim=-1) for k, v in logits.items()}
    return torch.argmax(logits, dim=-1)


def policy_decision(policy: nn.Module, obs, mask):
    """The deterministic decision: masked logits -> greedy actions."""
    logits, _ = policy(obs, mask)
    return greedy_actions(logits)


def policy_decision_full(policy: nn.Module, obs, mask):
    """:func:`policy_decision` plus the behavior record the flywheel
    logs: ``(actions, log_prob, value)``. The actions come from the same
    masked logits and argmax; ``log_prob`` is the joint log-probability
    of the greedy action (:func:`..algos.action_dist.log_prob`, summed
    over the heads of a dict policy) and ``value`` the critic's
    estimate, both f32."""
    from .algos import action_dist
    logits, value = policy(obs, mask)
    actions = greedy_actions(logits)
    return (actions,
            action_dist.log_prob(logits, actions).to(torch.float32),
            value.to(torch.float32))
