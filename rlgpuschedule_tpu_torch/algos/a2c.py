"""A2C trainer (L4) of the port: synchronous advantage actor-critic.

Counterpart of the JAX package's ``algos/a2c.py`` (config 3). It runs on
PPO's machinery: the rollout, GAE, the reward moments of
:func:`.ppo.update_reward_stats`, the bf16 grad-step contract of
:func:`.ppo.loss_and_backward` and the minibatch engine, whose default
``1 x 1`` geometry is the classic single full-batch update and consumes
no randomness. There is no advantage normalization and no off-policy
correction. The optimizer is optax's ``chain(clip_by_global_norm,
rmsprop(lr, decay=0.99, eps=1e-5))``, :class:`.ppo.ClippedRMSprop`.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Sequence

import torch
from torch import nn

from ..env.env import EnvParams
from ..ops.gae import compute_gae
from ..sim.core import Trace
from . import action_dist, ppo
from .ppo import (ClippedRMSprop, TrainState, loss_and_backward,
                  reward_scale, update_reward_stats)
from .rollout import PolicyApply, RolloutCarry, Transition, rollout
from .update import run_minibatch_epochs, tree_map


@dataclasses.dataclass(frozen=True)
class A2CConfig:
    n_steps: int = 16           # shorter rollouts, more frequent updates
    # update geometry (PPOConfig's contract); the 1 x 1 default is
    # classic A2C, one full-batch update per iteration
    n_epochs: int = 1
    n_minibatches: int = 1
    minibatch_size: int | None = None
    bf16_update: bool = False   # PPOConfig.bf16_update's contract
    # the advantage options of PPOConfig; A2C has no correction field
    reward_norm: bool = False
    bf16_advantages: bool = False
    gamma: float = 0.995
    gae_lambda: float = 1.0     # plain n-step advantage by default
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 7e-4
    max_grad_norm: float = 0.5


class A2CMetrics(NamedTuple):
    total_loss: torch.Tensor
    pg_loss: torch.Tensor
    v_loss: torch.Tensor
    entropy: torch.Tensor
    mean_reward: torch.Tensor
    mean_value: torch.Tensor


def make_optimizer(config: A2CConfig,
                   params: Iterable[torch.Tensor]) -> ClippedRMSprop:
    return ClippedRMSprop(params, config.lr, config.max_grad_norm,
                          decay=0.99, eps=1e-5)


def make_train_state(net: nn.Module, config: A2CConfig) -> TrainState:
    """The policy with its clipped RMSprop and, with
    ``config.reward_norm``, zeroed reward moments on its device."""
    return ppo.make_train_state(net, config,
                                make_optimizer(config, net.parameters()))


def a2c_loss(apply_fn: PolicyApply, batch: Transition,
             advantages: torch.Tensor, returns: torch.Tensor,
             config: A2CConfig):
    """Returns ``(total, (pg_loss, v_loss, entropy))``."""
    logits, value = apply_fn(batch.obs, batch.mask)
    log_prob = action_dist.log_prob(logits, batch.action)
    pg_loss = -torch.mean(log_prob * advantages)
    v_loss = 0.5 * torch.mean((value - returns) ** 2)
    entropy = torch.mean(action_dist.entropy(logits))
    total = pg_loss + config.vf_coef * v_loss - config.ent_coef * entropy
    return total, (pg_loss, v_loss, entropy)


def make_a2c_grad_step(config: A2CConfig):
    """One policy-gradient update on one minibatch for the update
    engine: ``(state, (mb, adv, ret)) -> (state, (loss, pg, vl,
    ent))``."""

    def grad_step(state: TrainState, mb_data):
        mb, adv, ret = mb_data
        state.opt.zero_grad(set_to_none=True)
        stats = loss_and_backward(a2c_loss, state.net, mb, adv, ret, config,
                                  config.bf16_update)
        state.opt.step()
        return state, stats

    return grad_step


def run_a2c_update(config: A2CConfig, state: TrainState, tr: Transition,
                   advantages: torch.Tensor, returns: torch.Tensor, *,
                   generator: torch.Generator | None = None,
                   perms: Sequence[torch.Tensor] | None = None,
                   ) -> tuple[TrainState, A2CMetrics]:
    """Flatten ``[T, E]`` to ``[B]`` and run the config's geometry
    through the update engine (the default ``1 x 1`` takes the batch
    whole)."""
    B = tr.reward.shape[0] * tr.reward.shape[1]
    flat = tree_map(lambda x: x.reshape(B, *x.shape[2:]), tr)
    state, stats = run_minibatch_epochs(
        make_a2c_grad_step(config), state,
        (flat, advantages.reshape(B), returns.reshape(B)),
        generator=generator, perms=perms, n_epochs=config.n_epochs,
        n_minibatches=config.n_minibatches,
        minibatch_size=config.minibatch_size)
    metrics = A2CMetrics(
        total_loss=stats[0].mean(), pg_loss=stats[1].mean(),
        v_loss=stats[2].mean(), entropy=stats[3].mean(),
        mean_reward=tr.reward.mean(), mean_value=tr.value.mean())
    return state, metrics


def make_learn_step(config: A2CConfig):
    """The learn half of the A2C iteration: ``(state, tr, last_value,
    generator=None, perms=None) -> (state, metrics)``: reward
    normalization, GAE (no advantage normalization), optional bf16
    targets, the update."""

    def learn_step(state: TrainState, tr: Transition,
                   last_value: torch.Tensor,
                   generator: torch.Generator | None = None,
                   perms: Sequence[torch.Tensor] | None = None):
        rewards = tr.reward
        if config.reward_norm:
            stats = update_reward_stats(state.reward_stats, rewards)
            rewards = rewards * reward_scale(stats)
            state = state._replace(reward_stats=stats)
        advantages, returns = compute_gae(rewards, tr.value, tr.done,
                                          last_value, config.gamma,
                                          config.gae_lambda)
        if config.bf16_advantages:
            advantages = advantages.to(torch.bfloat16)
            returns = returns.to(torch.bfloat16)
        return run_a2c_update(config, state, tr, advantages, returns,
                              generator=generator, perms=perms)

    return learn_step


def make_train_step(env_params: EnvParams, config: A2CConfig):
    """One A2C iteration: ``(state, carry, traces, generator[, faults])
    -> (state, carry', metrics)``, the rollout under ``faults`` (None: a
    healthy cluster); the rollout samples from the carry's generator,
    a shuffled geometry permutes with ``generator``."""
    learn_step = make_learn_step(config)

    def train_step(state: TrainState, carry: RolloutCarry, traces: Trace,
                   generator: torch.Generator, faults=None):
        carry, tr, last_value = rollout(state.net, env_params, traces,
                                        carry, config.n_steps,
                                        faults=faults)
        state, metrics = learn_step(state, tr, last_value, generator)
        return state, carry, metrics

    return train_step
