"""Weights from the JAX package's Flax parameter trees.

:func:`params_from_jax` turns a Flax ``ActorCritic`` parameter tree,
given as nested dicts of numpy arrays (what ``jax.device_get(params)``
returns), into a ``state_dict`` for the port's :class:`ActorCritic`.
:func:`load_npz` reads the same tree flattened to ``/``-joined keys in
an ``.npz`` file, so a policy trained by the JAX package is served here
without JAX. :func:`opt_state_from_jax` carries an optax Adam state the
same way, so a JAX ``TrainState`` taken mid-run continues here. Any
leaf the mapping does not know is refused, never dropped.

The mapping, leaf by leaf (Flax scope -> port module):

- ``.../Dense_i/kernel`` ``[in, out]`` -> ``.weight`` ``[out, in]``;
- ``.../Conv_i/kernel`` HWIO -> ``.weight`` OIHW;
- ``.../LayerNorm_i/scale`` -> ``.weight``;
- the heads' ``kernel`` -> ``.weight`` (transposed): ``policy`` and
  ``value``, for the GNN ``slot_policy``, ``preempt_policy``,
  ``noop_policy`` and ``value``, and for the hierarchical policy
  ``top_policy``, ``pod_policy`` and ``value``;
- every ``bias`` -> ``.bias``.

The trunk is ``encoder`` in the flat policies and the two trunks
``top_trunk`` and ``pod_trunk`` in the hierarchical one. The GNN's
adjacency is not a parameter on either side. :func:`member_params`
takes one member out of a JAX population's stacked ``[P, ...]``
parameters.
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_HEADS = ("policy|value|slot_policy|preempt_policy|noop_policy|top_policy|"
          "pod_policy")
_TRUNK = "(encoder|top_trunk|pod_trunk)"
_DENSE = re.compile(rf"({_TRUNK}/Dense_\d+|{_HEADS})/kernel")
_CONV = re.compile(r"encoder/Conv_\d+/kernel")
_SCALE = re.compile(rf"{_TRUNK}/LayerNorm_\d+/scale")
_BIAS = re.compile(rf"({_TRUNK}/(Dense|Conv|LayerNorm)_\d+|{_HEADS})/bias")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``state_dict`` of the port's actor-critic from a Flax parameter
    tree (with or without its top-level ``"params"`` collection)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree).items():
        a = np.array(leaf, np.float32)  # a writable copy
        if _DENSE.fullmatch(path):
            a, name = a.T, path[:-len("kernel")] + "weight"
        elif _CONV.fullmatch(path):
            a, name = a.transpose(3, 2, 0, 1), path[:-len("kernel")] + "weight"
        elif _SCALE.fullmatch(path):
            name = path[:-len("scale")] + "weight"
        elif _BIAS.fullmatch(path):
            name = path
        else:
            raise ValueError(
                f"no port counterpart for Flax parameter {path!r} "
                f"(shape {a.shape}); the port maps the MLP, CNN, GNN and "
                f"hierarchical actor-critics")
        out[name.replace("/", ".")] = torch.from_numpy(
            np.ascontiguousarray(a))
    return out


def member_params(tree: Mapping[str, Any], member: int) -> dict:
    """Member ``member``'s parameter tree out of a population's stacked
    tree (every leaf ``[P, ...]``, e.g. ``PopulationExperiment.states
    .params`` after ``jax.device_get``), as nested dicts of numpy
    arrays for :func:`params_from_jax`."""
    return {k: member_params(v, member) if isinstance(v, Mapping)
            else np.asarray(v)[member] for k, v in tree.items()}


def load_npz(path: str) -> dict[str, torch.Tensor]:
    """:func:`params_from_jax` of a Flax tree saved flat in an ``.npz``
    (keys such as ``params/encoder/Dense_0/kernel``)."""
    tree: dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return params_from_jax(tree)


def opt_state_from_jax(mu: Mapping[str, Any], nu: Mapping[str, Any],
                       count: Any, net: torch.nn.Module,
                       optimizer: torch.optim.Optimizer) -> dict:
    """A ``state_dict`` for ``optimizer`` (a ``torch.optim.Adam`` over
    ``net.parameters()``, in their order) from an optax Adam state: the
    first and second moments ``mu``/``nu`` (Flax parameter trees, mapped
    leaf by leaf as :func:`params_from_jax` maps the parameters) and the
    update ``count``. torch's ``step`` is optax's ``count``: both are the
    number of updates taken, and both bias corrections use it plus
    one."""
    mu_sd, nu_sd = params_from_jax(mu), params_from_jax(nu)
    names = [n for n, _ in net.named_parameters()]
    if set(mu_sd) != set(names) or set(nu_sd) != set(names):
        raise ValueError(
            f"the Adam moments name {sorted(set(mu_sd) ^ set(names))} "
            f"differently from the network's parameters")
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    state = {i: {"step": step.clone(), "exp_avg": mu_sd[n],
                 "exp_avg_sq": nu_sd[n]} for i, n in enumerate(names)}
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}
