"""Request batching helpers (L6) of the port.

Counterparts of ``next_bucket`` and ``pad_batch`` in the JAX package's
``serve/batching.py``. The continuous-batching ``PolicyServer`` waits
for a later slice."""
from __future__ import annotations

import numpy as np


def next_bucket(n: int, max_bucket: int) -> int:
    """The power-of-two batch bucket for ``n`` requests (smallest power
    of two >= n, capped by ``max_bucket``)."""
    if n <= 0:
        raise ValueError(f"need at least one request, got {n}")
    if max_bucket <= 0 or (max_bucket & (max_bucket - 1)):
        raise ValueError(f"max_bucket must be a positive power of two, "
                         f"got {max_bucket}")
    if n > max_bucket:
        raise ValueError(f"{n} requests exceed max_bucket={max_bucket}; "
                         f"drain in max_bucket-sized dispatches")
    return 1 << (n - 1).bit_length()


def pad_batch(batch: np.ndarray, bucket: int,
              fill_mask_true: bool = False) -> np.ndarray:
    """Pad a host batch from n rows up to ``bucket`` rows.

    Padding rows are zeros, except a boolean batch with
    ``fill_mask_true``: action masks pad with every action legal, so the
    padding rows' logits stay finite. A full bucket is returned as is."""
    x = np.asarray(batch)
    n = x.shape[0]
    if n > bucket:
        raise ValueError(f"batch of {n} rows exceeds bucket {bucket}")
    if n == bucket:
        return x
    value = True if (fill_mask_true and x.dtype == np.bool_) else 0
    return np.concatenate([x, np.full((bucket - n,) + x.shape[1:], value,
                                      x.dtype)])
