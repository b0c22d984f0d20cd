"""Minibatch-update engine (L4) of the port.

Counterpart of ``resolve_geometry``, ``validate_update_geometry``,
``cast_floating`` and ``run_minibatch_epochs`` in the JAX package's
``algos/update.py``: one
``n_epochs x n_minibatches x minibatch_size`` loop that calls a
``grad_step`` on contiguous blocks of the shuffled rollout batch.

The numerics contract is the JAX engine's: each epoch draws one
whole-batch permutation and gathers the batch through it once; the
minibatches are contiguous blocks of that shuffled batch. At the
degenerate ``1 x 1`` geometry the batch goes to ``grad_step`` whole,
unpermuted, and no randomness is consumed; at ``n_minibatches == 1``
the gather is skipped (a full-batch epoch sees every sample in any
order). The permutations come from an explicit ``torch.Generator`` on
the batch's device, or are given (``perms``), which lets a test feed
the JAX engine's own ``jax.random.permutation`` draws.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from ..tree import tree_map

# grad_step(state, minibatch_data) -> (state, stats): one optimizer update
# on one minibatch; ``stats`` is a tuple of scalar tensors, which the
# engine stacks to [n_epochs, n_minibatches].
GradStep = Callable[[Any, Any], tuple[Any, tuple]]


def resolve_geometry(n_epochs: int, n_minibatches: int,
                     minibatch_size: int | None,
                     batch_size: int) -> tuple[int, int, int]:
    """Validate the update geometry against the flattened rollout batch
    and return ``(n_epochs, n_minibatches, minibatch_size)``.
    ``minibatch_size``, when set, determines the minibatch count and
    ``n_minibatches`` is ignored. Everything must tile the batch
    exactly: a dropped remainder would train on less data than
    configured."""
    if n_epochs < 1:
        raise ValueError(f"n_epochs must be >= 1, got {n_epochs}")
    if minibatch_size is not None:
        if minibatch_size < 1:
            raise ValueError(
                f"minibatch_size must be >= 1, got {minibatch_size}")
        if batch_size % minibatch_size:
            raise ValueError(
                f"minibatch_size={minibatch_size} must divide the rollout "
                f"batch (n_steps * n_envs = {batch_size}); a remainder "
                f"minibatch would change shapes mid-epoch")
        n_minibatches = batch_size // minibatch_size
    else:
        if n_minibatches < 1:
            raise ValueError(
                f"n_minibatches must be >= 1, got {n_minibatches}")
        if batch_size % n_minibatches:
            raise ValueError(
                f"n_steps * n_envs = {batch_size} must be divisible by "
                f"n_minibatches={n_minibatches}")
        minibatch_size = batch_size // n_minibatches
    return n_epochs, n_minibatches, minibatch_size


def validate_update_geometry(n_epochs: int, n_minibatches: int,
                             minibatch_size: int | None, *, n_steps: int,
                             n_envs: int, n_devices: int = 1
                             ) -> tuple[int, int, int]:
    """Check that the trajectory batch tiles the update's device group
    (the env axis is what a group shards) and resolve the minibatch
    triple against the flattened ``n_steps * n_envs`` batch."""
    if n_devices > 1 and n_envs % n_devices:
        raise ValueError(
            f"n_envs={n_envs} must be divisible by the update device "
            f"group size ({n_devices}) to shard the trajectory batch")
    return resolve_geometry(n_epochs, n_minibatches, minibatch_size,
                            n_steps * n_envs)


def tree_stack(trees: Sequence[Any]) -> Any:
    """Stack a list of same-structured trees leaf by leaf along a new
    leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating tensor of ``tree`` to ``dtype``; bool and
    integer tensors (actions, masks, done flags) keep their dtypes."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def _first_leaf(tree: Any) -> torch.Tensor:
    while isinstance(tree, (tuple, dict)):
        if not tree:
            raise ValueError("update engine got an empty data tuple")
        tree = tree[0] if isinstance(tree, tuple) else next(iter(
            tree.values()))
    return tree


def run_minibatch_epochs(grad_step: GradStep, state: Any, data: Any, *,
                         generator: torch.Generator | None = None,
                         perms: Sequence[torch.Tensor] | None = None,
                         n_epochs: int = 1, n_minibatches: int = 1,
                         minibatch_size: int | None = None,
                         ) -> tuple[Any, tuple[torch.Tensor, ...]]:
    """Run ``grad_step`` over ``n_epochs`` shuffled passes of ``data`` (a
    nested tuple or dict of ``[B, ...]`` tensors) split into contiguous
    minibatches. Returns ``(state, stats)`` with every stat stacked to
    ``[n_epochs, n_minibatches]``.

    Each shuffled epoch takes its permutation from ``perms[epoch]`` when
    given, else draws ``torch.randperm(B)`` from ``generator``."""
    first = _first_leaf(data)
    B = first.shape[0]
    n_epochs, n_mb, mb = resolve_geometry(n_epochs, n_minibatches,
                                          minibatch_size, B)
    if n_epochs == 1 and n_mb == 1:
        # one full-batch update: no permutation, no randomness consumed
        state, stats = grad_step(state, data)
        return state, tuple(torch.stack([s]).reshape(1, 1) for s in stats)
    shuffled = n_mb > 1
    if shuffled:
        if perms is not None and len(perms) != n_epochs:
            raise ValueError(f"got {len(perms)} permutations for "
                             f"{n_epochs} epochs")
        if perms is None and generator is None:
            raise ValueError("a shuffled update needs a generator or perms")
    rows = []
    for epoch in range(n_epochs):
        if shuffled:
            perm = (perms[epoch].to(first.device) if perms is not None
                    else torch.randperm(B, generator=generator,
                                        device=first.device))
            # one whole-batch gather per epoch; minibatch i is then the
            # contiguous block i of the shuffled batch
            blocks = tree_map(
                lambda x: x[perm].reshape(n_mb, mb, *x.shape[1:]), data)
        else:
            blocks = tree_map(lambda x: x[None], data)
        for i in range(n_mb):
            state, stats = grad_step(state, tree_map(lambda x: x[i], blocks))
            rows.append(stats)
    return state, tuple(torch.stack(col).reshape(n_epochs, n_mb)
                        for col in zip(*rows))
