"""Bucketed greedy inference engine (L6) of the port.

Counterpart of the JAX package's ``serve/engine.py``. ``decide`` takes a
host batch of requests ``[n, ...]``, pads it to the next power-of-two
bucket, uploads it, runs the greedy decision rule
(:func:`..decision.policy_decision`, the one :func:`..eval.replay`
uses) and downloads the first ``n`` actions.

Transfers are explicit: each bucket has its own request buffers, pinned
when the engine serves a CUDA device, and uploads are
``non_blocking`` copies from them. The download that ends ``decide``
waits for the decision, and with it for the upload, so a buffer is
free again when ``decide`` returns.

The JAX engine's per-bucket compile accounting and its recompile and
implicit-transfer sentinels police XLA's jit cache and
``jax.transfer_guard``; the port compiles nothing, and their torch
counterparts (a CUDA-graph capture per bucket, a host-sync guard) wait
for a later slice. So do the capture mode and the preempt stall gate
(this slice has no preempt actions to gate).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..decision import policy_decision
from ..device import resolve_device
from .batching import next_bucket, pad_batch


class InferenceEngine:
    """Bucketed greedy policy inference on one device."""

    def __init__(self, policy: nn.Module, max_bucket: int = 256,
                 device: "torch.device | str | None" = None):
        if max_bucket <= 0 or (max_bucket & (max_bucket - 1)):
            raise ValueError(f"max_bucket must be a positive power of "
                             f"two, got {max_bucket}")
        self.device = resolve_device(device)
        for name, p in policy.state_dict().items():
            if p.device.type != self.device.type:
                raise ValueError(
                    f"policy parameter {name!r} lives on {p.device}, the "
                    f"engine serves {self.device}; move the policy first")
        self.policy = policy
        self.max_bucket = max_bucket
        self._pin = self.device.type == "cuda"
        self._staging: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
        self._warmed: set[int] = set()

    @property
    def warmed_buckets(self) -> "tuple[int, ...]":
        return tuple(sorted(self._warmed))

    def bucket_for(self, n: int) -> int:
        return next_bucket(n, self.max_bucket)

    def set_params(self, state_dict: "dict[str, torch.Tensor]") -> None:
        """Swap the served weights in place. The new weights must have
        the incumbent's names, shapes and dtypes; anything else is a
        redeploy, and is refused."""
        old = self.policy.state_dict()
        if set(old) != set(state_dict):
            raise ValueError(
                f"param swap changed the parameter names (missing "
                f"{sorted(set(old) - set(state_dict))}, unexpected "
                f"{sorted(set(state_dict) - set(old))}); redeploy instead")
        for k, a in old.items():
            b = state_dict[k]
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(
                    f"param swap changed {k!r} from {tuple(a.shape)}/"
                    f"{a.dtype} to {tuple(b.shape)}/{b.dtype}; redeploy "
                    f"instead")
        self.policy.load_state_dict(state_dict)

    def _buffers(self, bucket: int, obs: np.ndarray, mask: np.ndarray,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        key = (bucket, obs.shape[1:], obs.dtype, mask.shape[1:])
        bufs = self._staging.get(key)
        if bufs is None:
            bufs = tuple(
                torch.empty((bucket,) + x.shape[1:],
                            dtype=torch.from_numpy(x[:0]).dtype,
                            pin_memory=self._pin)
                for x in (obs, mask))
            self._staging[key] = bufs
        return bufs

    def decide(self, obs: np.ndarray, mask: np.ndarray,
               ) -> "tuple[np.ndarray, int]":
        """Decide one request batch: ``obs``/``mask`` are host arrays with
        a leading request axis. Returns ``(actions[:n] on the host,
        bucket)``."""
        n = int(obs.shape[0])
        bucket = self.bucket_for(n)
        obs_p = pad_batch(obs, bucket)
        mask_p = pad_batch(mask, bucket, fill_mask_true=True)
        obs_h, mask_h = self._buffers(bucket, obs_p, mask_p)
        obs_h.copy_(torch.from_numpy(obs_p))
        mask_h.copy_(torch.from_numpy(mask_p))
        obs_d = obs_h.to(self.device, non_blocking=True)
        mask_d = mask_h.to(self.device, non_blocking=True)
        with torch.inference_mode():
            actions = policy_decision(self.policy, obs_d, mask_d)
        self._warmed.add(bucket)
        # i32 on the host, as the JAX engine returns them
        return actions.to("cpu").numpy()[:n].astype(np.int32), bucket

    def warmup(self, example_obs: np.ndarray, example_mask: np.ndarray,
               buckets: "tuple[int, ...]" = ()) -> "tuple[int, ...]":
        """Run one neutral batch through each bucket (every power of two
        up to ``max_bucket`` by default), so that allocations and library
        autotuning happen before live traffic. ``example_*`` are one
        request, no leading axis. Returns the buckets warmed by this
        call."""
        if not buckets:
            buckets = tuple(1 << i
                            for i in range(self.max_bucket.bit_length()))
        done = []
        for b in sorted(set(buckets)):
            if b != next_bucket(b, self.max_bucket):
                raise ValueError(f"bucket {b} is not a power of two "
                                 f"<= max_bucket={self.max_bucket}")
            if b in self._warmed:
                continue
            obs = np.zeros((b,) + np.shape(example_obs),
                           np.asarray(example_obs).dtype)
            mask = np.ones((b,) + np.shape(example_mask),
                           np.asarray(example_mask).dtype)
            self.decide(obs, mask)
            done.append(b)
        return tuple(done)
