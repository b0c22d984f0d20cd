"""Hierarchical actor-critic (L3) of the port: config 5's policy.

Counterpart of the JAX package's ``models/hier.py``: one module holds
the top-level router head and the per-pod placement head. The pod
trunk's weights are shared across pods (its Dense layers broadcast over
the pod axis, so the P pod forwards are one batched matmul); the router
sees its own summary observation and the mean of the pod embeddings. A
single critic values the joint state. Initialization as in
:mod:`.actor_critic`: the trunks' ``lecun_normal`` kernels, the policy
heads ``orthogonal(0.01)``, the value head ``orthogonal(1.0)``, all
from one generator. Module names follow the Flax scopes
(``top_trunk``, ``pod_trunk``, ``top_policy``, ``pod_policy``,
``value``), so :mod:`.convert` maps a JAX parameter tree onto it."""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .actor_critic import mask_logits
from .encoders import Dense, MLPEncoder


class HierActorCritic(nn.Module):
    """``forward(obs, mask) -> (logits, value)`` with
    ``obs = {"top": [*B, Dt], "pods": [*B, P, Dp]}``,
    ``mask = {"top": [*B, P+1], "pods": [*B, P, A]}``,
    ``logits = {"top": [*B, P+1], "pods": [*B, P, A]}`` (masked, f32;
    see :mod:`..algos.action_dist` for the stacked-head rule) and
    ``value [*B]`` (f32)."""

    def __init__(self, top_features: int, pod_features: int,
                 n_top_actions: int, n_pod_actions: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.top_trunk = MLPEncoder(top_features, dtype=dtype)
        self.pod_trunk = MLPEncoder(pod_features, dtype=dtype)
        d_top = self.top_trunk.out_features
        d_pod = self.pod_trunk.out_features
        f32 = torch.float32
        self.top_policy = Dense(d_top + d_pod, n_top_actions, f32)
        self.pod_policy = Dense(d_pod, n_pod_actions, f32)
        self.value = Dense(d_top + d_pod, 1, f32)

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        for trunk in (self.top_trunk, self.pod_trunk):
            for m in trunk.modules():
                if hasattr(m, "reset_parameters"):
                    m.reset_parameters(generator)
        with torch.no_grad():
            for head, gain in ((self.top_policy, 0.01),
                               (self.pod_policy, 0.01), (self.value, 1.0)):
                nn.init.orthogonal_(head.weight, gain, generator=generator)
                head.bias.zero_()

    def forward(self, obs: dict, mask: dict) -> tuple[dict, torch.Tensor]:
        top_h = self.top_trunk(obs["top"])
        pod_h = self.pod_trunk(obs["pods"])
        pooled = pod_h.mean(-2)
        joint = torch.cat([top_h, pooled], dim=-1)
        logits = {"top": mask_logits(self.top_policy(joint), mask["top"]),
                  "pods": mask_logits(self.pod_policy(pod_h), mask["pods"])}
        return logits, self.value(joint).squeeze(-1)


def make_hier_policy(env_params, *, dtype: torch.dtype = torch.bfloat16,
                     seed: int = 0,
                     device: "torch.device | str | None" = None,
                     ) -> HierActorCritic:
    """The hierarchical actor-critic over ``env_params``'
    (:class:`..env.hier.HierParams`) observations and actions,
    initialized from ``seed`` on the CPU (the same weights on every
    device) and moved to ``device``."""
    dev = resolve_device(device)
    shape = env_params.obs_shape()
    net = HierActorCritic(shape["top"][0], shape["pods"][-1],
                          env_params.n_top_actions,
                          env_params.pod_sim.n_actions, dtype=dtype)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net.to(dev)
