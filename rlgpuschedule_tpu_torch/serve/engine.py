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

On a preemptive action space, an engine given ``env_params`` applies
the stall gate (:func:`..decision.gate_stalled`) on the device: each
request carries its cluster's count of consecutive zero-dt steps, and
past the threshold its preempt actions are masked, as replay masks
them.

The JAX engine's per-bucket compile accounting and its recompile and
implicit-transfer sentinels police XLA's jit cache and
``jax.transfer_guard``; the port compiles nothing, and their torch
counterparts (a CUDA-graph capture per bucket, a host-sync guard) wait
for a later slice. So does the capture mode.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..decision import (gate_stalled, policy_decision, preempt_slice,
                        stall_threshold)
from ..device import resolve_device
from .batching import next_bucket, pad_batch


class InferenceEngine:
    """Bucketed greedy policy inference on one device."""

    def __init__(self, policy: nn.Module, max_bucket: int = 256,
                 device: "torch.device | str | None" = None,
                 env_params=None):
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
        # the gate's preempt slice, built once on the serving device
        self._pre = (preempt_slice(env_params, self.device)
                     if env_params is not None else None)
        self._thresh = (stall_threshold(env_params)
                        if self._pre is not None else 0)
        self._staging: dict[tuple, tuple[torch.Tensor, ...]] = {}
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

    def _buffers(self, bucket: int, arrays: "tuple[np.ndarray, ...]",
                 ) -> "tuple[torch.Tensor, ...]":
        key = (bucket,) + tuple((x.shape[1:], x.dtype) for x in arrays)
        bufs = self._staging.get(key)
        if bufs is None:
            bufs = tuple(
                torch.empty((bucket,) + x.shape[1:],
                            dtype=torch.from_numpy(x[:0]).dtype,
                            pin_memory=self._pin)
                for x in arrays)
            self._staging[key] = bufs
        return bufs

    def decide(self, obs: np.ndarray, mask: np.ndarray,
               stall: "np.ndarray | None" = None,
               ) -> "tuple[np.ndarray, int]":
        """Decide one request batch: ``obs``/``mask`` are host arrays with
        a leading request axis; ``stall`` is ``i32[n]`` consecutive
        zero-dt steps per request (zeros if None; ignored unless the
        action space has preempt actions to gate). Returns
        ``(actions[:n] on the host, bucket)``."""
        n = int(obs.shape[0])
        bucket = self.bucket_for(n)
        arrays = (pad_batch(obs, bucket),
                  pad_batch(mask, bucket, fill_mask_true=True))
        if self._pre is not None:
            if stall is None:
                stall = np.zeros(n, np.int32)
            arrays += (pad_batch(np.asarray(stall, np.int32), bucket),)
        dev = []
        for host, x in zip(self._buffers(bucket, arrays), arrays):
            host.copy_(torch.from_numpy(x))
            dev.append(host.to(self.device, non_blocking=True))
        with torch.inference_mode():
            mask_d = dev[1]
            if self._pre is not None:
                mask_d = gate_stalled(mask_d, dev[2], self._thresh,
                                      self._pre)
            actions = policy_decision(self.policy, dev[0], mask_d)
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
