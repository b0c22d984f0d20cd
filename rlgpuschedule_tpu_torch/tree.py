"""Nested containers of arrays ("trees"), without torch and without JAX.

The port's counterpart of the few ``jax.tree.*`` calls the JAX package
makes on host data: a tree is a dict, a tuple (``NamedTuple`` included)
or a list of trees, and anything else is a leaf (a numpy array, a
tensor, a scalar). A flat observation is a one-leaf tree.

:func:`leaves` walks a dict in sorted key order, as ``jax.tree.leaves``
does, so two dicts with the same keys flatten alike whatever their
insertion order; :func:`tree_map` keeps the first tree's key order and
looks the other trees' leaves up by key."""
from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np


def _rebuild(tree: Any, items: list) -> Any:
    if isinstance(tree, list):
        return items
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` on every leaf of ``tree``; with ``rest``, on the matching
    leaves of every tree (same structure)."""
    if isinstance(tree, (tuple, list)):
        return _rebuild(tree, [tree_map(fn, *xs) for xs in zip(tree, *rest)])
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in a fixed order (dict keys sorted)."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def structure(tree: Any) -> Any:
    """A hashable description of ``tree``'s containers (leaves are
    ``None``): two trees with equal structures flatten alike."""
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(structure(t) for t in tree))
    if isinstance(tree, dict):
        return ("dict", tuple((k, structure(tree[k])) for k in sorted(tree)))
    return None


def unflatten(like: Any, flat: Sequence[Any]) -> Any:
    """The tree of ``like``'s structure whose leaves are ``flat``, in
    :func:`leaves` order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, (tuple, list)):
            return _rebuild(t, [build(x) for x in t])
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def stack(trees: Sequence[Any]) -> Any:
    """Stack same-structured trees of arrays leaf by leaf along a new
    leading axis (numpy)."""
    return tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                    *trees)


def index(tree: Any, i) -> Any:
    """Row ``i`` (an index or a slice) of every leaf."""
    return tree_map(lambda x: x[i], tree)
