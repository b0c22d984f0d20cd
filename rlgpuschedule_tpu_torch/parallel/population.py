"""Population training (L5) of the port: the substrate of config 5's PBT.

Counterpart of ``HParams``, ``HPARAM_BOUNDS``, ``MemberState``,
``init_member``, ``make_member_tx``, ``make_member_learn_step``,
``make_member_step``, ``stack_members`` and ``sample_hparams`` in the
JAX package's ``parallel/population.py``. There the member train step is
``vmap``-ped over a stacked member axis and sharded over a ``pop`` mesh
axis; one H100 has no such axis, so here a population is a list of
members, each with its own policy, optimizer, generators and rollout
carry, stepped in turn over the one shared ``Trace`` batch (never copied
per member, JAX's ``in_axes=None``). The mesh layer
(``member_stack_specs``, ``population_shardings``,
``jit_population_step``) goes with the data-parallel slice
(``ROADMAP.md`` queue 1, item 21).

Per-member hyperparameters (lr, entropy coefficient, clip epsilon) are
f32 values (:class:`HParams`, host numpy ``[P]``), not the config's
Python floats: PBT's explore rewrites them between iterations. The
member's optimizer is the clipped Adam with no learning rate of its own:
its param group's ``lr`` is set from the member's ``lr`` before every
update, and ``clip_eps`` and ``ent_coef`` reach the loss as f32 scalars
on the device (:func:`member_hparams`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from ..algos.ppo import (ClippedAdam, PPOConfig, compute_advantages,
                         run_ppo_epochs)
from ..algos.rollout import RolloutCarry, rollout
from ..algos.update import tree_stack


class HParams(NamedTuple):
    """PBT-explorable hyperparameters: f32 ``[P]`` arrays across the
    population (host numpy), or one member's scalars
    (:func:`member_hparams`)."""
    lr: np.ndarray
    ent_coef: np.ndarray
    clip_eps: np.ndarray


# Legal range per hyperparameter; initial sampling and PBT explore both
# clip to these.
HPARAM_BOUNDS: dict[str, tuple[float, float]] = {
    "lr": (1e-5, 1e-2),
    "ent_coef": (1e-4, 0.3),
    "clip_eps": (0.05, 0.5),
}


class MemberState(NamedTuple):
    """One member's learnable state: the policy and its optimizer (Adam's
    moments and its step count, JAX's ``opt_state`` and ``step``, live
    in the optimizer's state), both updated in place."""
    net: nn.Module
    opt: ClippedAdam


def make_member_optimizer(config: PPOConfig,
                          params) -> ClippedAdam:
    """JAX's ``make_member_tx``: clip by global norm, then Adam with
    ``eps=1e-5``; its ``lr`` is the member's, set by the learn step."""
    return ClippedAdam(params, 0.0, config.max_grad_norm)


def init_member(net: nn.Module, config: PPOConfig) -> MemberState:
    return MemberState(net, make_member_optimizer(config, net.parameters()))


def member_hparams(hp: HParams, member: int,
                   device: "torch.device | str") -> HParams:
    """Member ``member``'s hyperparameters as its learn step takes them:
    ``lr`` an ``np.float32`` on the host (it goes into the optimizer's
    param group), ``ent_coef`` and ``clip_eps`` f32 scalar tensors on
    ``device``. Built once per exploit round, not per step: a host to
    device copy would wait for the card."""
    return HParams(
        lr=np.float32(hp.lr[member]),
        ent_coef=torch.tensor(hp.ent_coef[member], dtype=torch.float32,
                              device=device),
        clip_eps=torch.tensor(hp.clip_eps[member], dtype=torch.float32,
                              device=device))


def make_member_learn_step(config: PPOConfig) -> Callable:
    """The learn half of one member's PPO iteration with its own
    hyperparameters: ``(member_state, tr, last_value, generator, hp,
    perms=None) -> (member_state, metrics)``. The advantage pipeline is
    :func:`..algos.ppo.compute_advantages` and the update
    :func:`..algos.ppo.run_ppo_epochs` with ``hp.clip_eps`` and
    ``hp.ent_coef`` in the loss and ``hp.lr`` on Adam's step, so a member
    at the config's values takes the plain PPO step."""
    if config.reward_norm:
        raise ValueError(
            "reward_norm is not supported in the PBT population: "
            "MemberState carries no reward_stats (per-member streaming "
            "moments would make fitness incomparable across members)")

    def member_learn_step(state: MemberState, tr, last_value: torch.Tensor,
                          generator: torch.Generator | None, hp: HParams,
                          perms: Sequence[torch.Tensor] | None = None):
        for group in state.opt.param_groups:
            group["lr"] = float(hp.lr)
        state, advantages, returns, rho_stats = compute_advantages(
            config, state, tr, last_value)
        return run_ppo_epochs(config, state, tr, advantages, returns,
                              generator=generator, perms=perms,
                              rho_stats=rho_stats, clip_eps=hp.clip_eps,
                              ent_coef=hp.ent_coef)

    return member_learn_step


def make_member_step(env_params, config: PPOConfig) -> Callable:
    """One member's full PPO iteration: ``(member_state, carry, traces,
    generator, hp[, faults]) -> (member_state, carry', metrics)``, the
    rollout (sampling from the carry's generator, under the member's
    batched ``faults``) composed with :func:`make_member_learn_step`
    (permuting with ``generator``)."""
    learn = make_member_learn_step(config)

    def member_step(state: MemberState, carry: RolloutCarry, traces,
                    generator: torch.Generator, hp: HParams, faults=None):
        carry, tr, last_value = rollout(state.net, env_params, traces,
                                        carry, config.n_steps,
                                        faults=faults)
        state, metrics = learn(state, tr, last_value, generator, hp)
        return state, carry, metrics

    return member_step


def stack_members(trees: Sequence) -> object:
    """Stack per-member trees of tensors (metrics, say) into one ``[P,
    ...]`` tree."""
    return tree_stack(trees)


def sample_hparams(base: PPOConfig, n_pop: int, seed: int,
                   spread: float = 3.0) -> HParams:
    """Initial population hyperparameters: log-uniform over ``[base /
    spread, base * spread]`` around the config's values (standard PBT
    initialization), clipped to :data:`HPARAM_BOUNDS`; f32 ``[P]``. The
    same numpy draws as JAX's, so the same values."""
    rng = np.random.default_rng(seed)

    def draw(name: str, center: float) -> np.ndarray:
        lo, hi = np.log(center / spread), np.log(center * spread)
        vals = np.exp(rng.uniform(lo, hi, size=n_pop)).astype(np.float32)
        return np.clip(vals, *HPARAM_BOUNDS[name]).astype(np.float32)

    return HParams(lr=draw("lr", base.lr),
                   ent_coef=draw("ent_coef", base.ent_coef),
                   clip_eps=draw("clip_eps", base.clip_eps))
