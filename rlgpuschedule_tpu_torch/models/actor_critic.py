"""Actor-critic heads (L3) of the port.

Counterpart of ``mask_logits``, ``ActorCritic``, ``GNNActorCritic``
and ``make_policy`` in the JAX package's ``models/actor_critic.py``:
action logits over [queue slots x placements][preempt slots][no-op] and
a value, infeasible actions masked to -1e9. The heads run in f32 on the
trunk's upcast output, as there.

Initialization draws from the distributions Flax uses: ``lecun_normal``
kernels and zero biases in the trunk, ``orthogonal(0.01)`` for the
policy heads and ``orthogonal(1.0)`` for the value head, all from one
explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .encoders import (CNNEncoder, Dense, GNNEncoder, MLPEncoder,
                       normalize_adjacency)

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


class GNNActorCritic(nn.Module):
    """Graph actor-critic (config 4). Each queue slot's ``n_placements``
    logits come from that slot's own node embedding (nodes N..N+K-1),
    each running slot's preempt logit from its node (N+K..N+K+R-1), the
    no-op logit and the value from the mean-pooled embedding.

    The normalized adjacency (:func:`normalize_adjacency`, held in the
    trunk dtype) is a buffer that is not part of ``state_dict``, so
    ``forward(obs, mask)`` has the signature of :class:`ActorCritic` and
    the weights' names are those of the Flax tree."""

    def __init__(self, encoder: GNNEncoder, adjacency: np.ndarray,
                 n_cluster_nodes: int, queue_len: int,
                 n_placements: int = 1, preempt_len: int = 0):
        super().__init__()
        self.encoder = encoder
        self.register_buffer(
            "a_norm", normalize_adjacency(adjacency).to(encoder.dtype),
            persistent=False)
        self.n_cluster_nodes = n_cluster_nodes
        self.queue_len = queue_len
        self.preempt_len = preempt_len
        d = encoder.out_features
        f32 = torch.float32
        self.slot_policy = Dense(d, n_placements, f32)
        if preempt_len:
            self.preempt_policy = Dense(d, 1, f32)
        self.noop_policy = Dense(d, 1, f32)
        self.value = Dense(d, 1, f32)

    def _heads(self):
        gains = [("slot_policy", 0.01), ("preempt_policy", 0.01),
                 ("noop_policy", 0.01), ("value", 1.0)]
        return [(getattr(self, n), g) for n, g in gains if hasattr(self, n)]

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        for m in self.encoder.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        with torch.no_grad():
            for head, gain in self._heads():
                nn.init.orthogonal_(head.weight, gain, generator=generator)
                head.bias.zero_()

    def forward(self, obs: torch.Tensor, mask: torch.Tensor,
                ) -> tuple[torch.Tensor, torch.Tensor]:
        h = self.encoder(obs, self.a_norm)                    # [E, V, D]
        pooled = h.mean(-2)
        n0, k = self.n_cluster_nodes, self.queue_len
        slot = self.slot_policy(h[:, n0:n0 + k])             # [E, K, P]
        parts = [slot.reshape(slot.shape[0], -1)]
        if self.preempt_len:
            runs = h[:, n0 + k:n0 + k + self.preempt_len]    # [E, R, D]
            parts.append(self.preempt_policy(runs).squeeze(-1))
        parts.append(self.noop_policy(pooled))
        logits = torch.cat(parts, -1)
        return mask_logits(logits, mask), self.value(pooled).squeeze(-1)


def make_policy(obs_kind: str, n_actions: int, obs_shape: Sequence[int], *,
                dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                device: "torch.device | str | None" = None,
                adjacency: np.ndarray | None = None,
                n_cluster_nodes: int = 0, queue_len: int = 0,
                n_placements: int = 1, preempt_len: int = 0,
                ) -> "ActorCritic | GNNActorCritic":
    """The actor-critic for ``obs_kind`` ("flat" -> MLP, "grid" -> CNN,
    "graph" -> GNN over ``adjacency``, with the cluster, queue, placement
    and preempt counts of the action layout) over per-cluster
    observations of ``obs_shape``, initialized from ``seed`` on the CPU
    (so a seed gives the same weights on every device) and moved to
    ``device``."""
    dev = resolve_device(device)
    if obs_kind == "flat":
        (n_in,) = obs_shape
        net: nn.Module = ActorCritic(MLPEncoder(n_in, dtype=dtype), n_actions)
    elif obs_kind == "grid":
        h, w, c = obs_shape
        net = ActorCritic(CNNEncoder((h, w, c), dtype=dtype), n_actions)
    elif obs_kind == "graph":
        v, f = obs_shape
        if adjacency is None or np.shape(adjacency) != (v, v):
            raise ValueError(f"the graph policy needs the [{v}, {v}] "
                             f"adjacency of its observations")
        want = queue_len * n_placements + preempt_len + 1
        if n_actions != want or v != n_cluster_nodes + queue_len \
                + preempt_len:
            raise ValueError(
                f"graph layout (N={n_cluster_nodes}, K={queue_len}, "
                f"P={n_placements}, R={preempt_len}) does not give "
                f"{n_actions} actions over {v} nodes")
        net = GNNActorCritic(GNNEncoder(f, dtype=dtype), adjacency,
                             n_cluster_nodes, queue_len, n_placements,
                             preempt_len)
    else:
        raise ValueError(f"unknown obs_kind {obs_kind!r}")
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net.to(dev)
