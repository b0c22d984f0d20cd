"""Cluster-state encoders (L3) of the port: MLP, CNN and GNN.

Counterparts of ``MLPEncoder``, ``CNNEncoder`` and ``GNNEncoder`` in the
JAX package's ``models/encoders.py``. Numerics follow Flax, layer by layer, with
explicit casts rather than ``torch.autocast`` (whose per-op choices
differ, most of all on the CPU):

- parameters are f32; each layer casts its input and its parameters to
  the module ``dtype`` (bf16 by default) and computes there;
- LayerNorm normalizes over the last axis with f32 statistics (the fast
  variance E[x^2] - E[x]^2, clipped at 0), epsilon 1e-6, then casts its
  output back to ``dtype``;
- the CNN keeps activations NHWC between layers, as Flax does, and
  pads each convolution as Flax's ``SAME`` does: for stride 2 that is
  asymmetric (lo = total // 2), which ``padding="same"`` cannot express.

Weights are laid out the PyTorch way (``[out, in]``, OIHW); module
names follow the Flax scopes (``Dense_0``, ``LayerNorm_0``, ``Conv_0``,
numbered in the order the Flax module creates them) so that :mod:`.convert` maps one onto the other name for name.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Flax's lecun_normal draws a standard normal truncated to [-2, 2] and
# divides by that truncated normal's std, so the kernel's variance is
# exactly 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None) -> torch.Tensor:
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return w.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


class Dense(nn.Module):
    """``y = x @ W.T + b`` in ``dtype``; the matmul and the bias add are
    separate ops, each rounded to ``dtype``, as in Flax. ``bias=False``
    is Flax's ``use_bias=False`` (no bias parameter at all)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16, bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())
        return y if self.bias is None else y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """Flax ``LayerNorm`` over the last axis (f32 statistics, eps 1e-6)."""

    eps = 1e-6

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mean * mean,
                              0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * mul + self.bias).to(self.dtype)


def same_padding(size: int, stride: int, kernel: int) -> tuple[int, int]:
    """(lo, hi) padding of Flax/XLA ``SAME`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """3x3 ``SAME`` convolution on NHWC activations, in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int,
                 stride: tuple[int, int], in_hw: tuple[int, int],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        ph = same_padding(in_hw[0], stride[0], 3)
        pw = same_padding(in_hw[1], stride[1], 3)
        self.pad = (pw[0], pw[1], ph[0], ph[1])   # F.pad: last axis first
        self.out_hw = (-(-in_hw[0] // stride[0]), -(-in_hw[1] // stride[1]))
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x.to(self.dtype).permute(0, 3, 1, 2), self.pad)
        y = F.conv2d(x, self.weight.to(self.dtype), None, self.stride)
        return y.permute(0, 2, 3, 1) + self.bias.to(self.dtype)


class MLPEncoder(nn.Module):
    """Dense trunk for flat observations (config 1)."""

    def __init__(self, in_features: int, features: Sequence[int] = (256, 256),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.n_layers = len(features)
        self.out_features = features[-1]
        d = in_features
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}", Dense(d, f, dtype))
            self.add_module(f"LayerNorm_{i}", LayerNorm(f, dtype))
            d = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            x = getattr(self, f"LayerNorm_{i}")(x)
            x = F.silu(x)
        return x


class CNNEncoder(nn.Module):
    """Conv trunk over the ``[H, W, C]`` occupancy image (config 2).

    The first layer keeps full resolution; later layers stride 2 along
    the node axis only (H halves per layer) while the narrow GPU axis
    keeps its width. Output: ``dense`` features per image."""

    def __init__(self, in_shape: tuple[int, int, int],
                 features: Sequence[int] = (32, 64, 64), dense: int = 256,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.n_layers = len(features)
        self.out_features = dense
        h, w, c = in_shape
        for i, f in enumerate(features):
            conv = Conv(c, f, (2, 1) if i else (1, 1), (h, w), dtype)
            self.add_module(f"Conv_{i}", conv)
            self.add_module(f"LayerNorm_{i}", LayerNorm(f, dtype))
            (h, w), c = conv.out_hw, f
        # flattened in H, W, C order, as Flax reshapes NHWC
        self.add_module("Dense_0", Dense(h * w * c, dense, dtype))
        self.add_module(f"LayerNorm_{self.n_layers}", LayerNorm(dense, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"Conv_{i}")(x)
            x = getattr(self, f"LayerNorm_{i}")(x)
            x = F.silu(x)
        x = x.reshape(x.shape[0], -1)
        x = self.Dense_0(x)
        x = getattr(self, f"LayerNorm_{self.n_layers}")(x)
        return F.silu(x)


def normalize_adjacency(adjacency: np.ndarray) -> torch.Tensor:
    """``A_hat = adj / max(deg, 1)`` of a static 0/1 adjacency ``[V, V]``,
    in f32 on the CPU, as the JAX encoder computes it on every call. The
    degrees are exact integers and the division is correctly rounded, so
    the bits are the same on every device; compute it once per topology
    and cast it to the trunk dtype."""
    adj = torch.as_tensor(np.asarray(adjacency, np.float32))
    return adj / torch.clamp_min(adj.sum(-1, keepdim=True), 1.0)


class GNNEncoder(nn.Module):
    """Dense message passing over the cluster-topology graph (config 4):
    per-node embeddings ``[E, V, D]`` from node features ``[E, V, F]``
    and the static normalized adjacency ``A_hat``
    (:func:`normalize_adjacency`).

    Each layer is ``silu(LN(A_hat (h W_msg + b) + h W_self))`` with
    ``A_hat`` cast to ``dtype`` before the product, as Flax casts it.
    Module names follow Flax's call order: per layer
    the message ``Dense_{2i}`` (with a bias), the self ``Dense_{2i+1}``
    (without) and ``LayerNorm_i``."""

    def __init__(self, in_features: int,
                 features: Sequence[int] = (128, 128, 128),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.n_layers = len(features)
        self.out_features = features[-1]
        d = in_features
        for i, f in enumerate(features):
            self.add_module(f"Dense_{2 * i}", Dense(d, f, dtype))
            self.add_module(f"Dense_{2 * i + 1}",
                            Dense(d, f, dtype, bias=False))
            self.add_module(f"LayerNorm_{i}", LayerNorm(f, dtype))
            d = f

    def forward(self, x: torch.Tensor, a_norm: torch.Tensor) -> torch.Tensor:
        a_norm = a_norm.to(self.dtype)              # no-op when held cast
        h = x.to(self.dtype)
        for i in range(self.n_layers):
            msg = getattr(self, f"Dense_{2 * i}")(h)
            agg = torch.matmul(a_norm, msg)                  # [E, V, D]
            self_h = getattr(self, f"Dense_{2 * i + 1}")(h)
            h = F.silu(getattr(self, f"LayerNorm_{i}")(agg + self_h))
        return h
