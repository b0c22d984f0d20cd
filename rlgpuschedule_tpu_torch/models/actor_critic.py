"""Actor-critic heads (L3) of the port.

Counterpart of ``mask_logits``, ``ActorCritic`` and ``make_policy`` in
the JAX package's ``models/actor_critic.py``: action logits over
[queue slots][no-op] and a value, infeasible actions masked to -1e9.
The heads run in f32 on the trunk's upcast output, as there. The graph
actor-critic waits for the config-4 slice.

Initialization draws from the distributions Flax uses: ``lecun_normal``
kernels and zero biases in the trunk, ``orthogonal(0.01)`` for the
policy head and ``orthogonal(1.0)`` for the value head, all from one
explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..device import resolve_device
from .encoders import CNNEncoder, Dense, MLPEncoder

NEG_INF = -1e9


def mask_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, logits, NEG_INF)


class ActorCritic(nn.Module):
    """Pooled-trunk actor-critic (MLP and CNN encoders).

    ``forward(obs, mask) -> (masked_logits f32, value f32)``."""

    def __init__(self, encoder: nn.Module, n_actions: int):
        super().__init__()
        self.encoder = encoder
        d = encoder.out_features
        self.policy = Dense(d, n_actions, torch.float32)
        self.value = Dense(d, 1, torch.float32)

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        for m in self.encoder.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        with torch.no_grad():
            for head, gain in ((self.policy, 0.01), (self.value, 1.0)):
                nn.init.orthogonal_(head.weight, gain, generator=generator)
                head.bias.zero_()

    def forward(self, obs: torch.Tensor, mask: torch.Tensor,
                ) -> tuple[torch.Tensor, torch.Tensor]:
        h = self.encoder(obs)
        logits = self.policy(h)
        value = self.value(h)
        return mask_logits(logits, mask), value.squeeze(-1)


def make_policy(obs_kind: str, n_actions: int, obs_shape: Sequence[int], *,
                dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                device: "torch.device | str | None" = None) -> ActorCritic:
    """The actor-critic for ``obs_kind`` ("flat" -> MLP, "grid" -> CNN)
    over per-cluster observations of ``obs_shape``, initialized from
    ``seed`` on the CPU (so a seed gives the same weights on every
    device) and moved to ``device``."""
    dev = resolve_device(device)
    if obs_kind == "flat":
        (n_in,) = obs_shape
        enc: nn.Module = MLPEncoder(n_in, dtype=dtype)
    elif obs_kind == "grid":
        h, w, c = obs_shape
        enc = CNNEncoder((h, w, c), dtype=dtype)
    elif obs_kind == "graph":
        raise NotImplementedError(
            "obs_kind='graph': the GNN actor-critic (gnn-gang-place) "
            "waits for the config-4 slice")
    else:
        raise ValueError(f"unknown obs_kind {obs_kind!r}")
    net = ActorCritic(enc, n_actions)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net.to(dev)
