"""Rollout collection (L4) of the port.

Counterpart of ``Transition``, ``RolloutCarry``, ``init_carry``,
``validate_rollout_geometry`` and ``rollout`` in the JAX package's
``algos/rollout.py``. There the policy forward, the sample and the
batched env step fuse into one ``lax.scan``; here they are a Python loop
over ``T`` steps whose body stays on the device: no value comes back to
the host inside the loop.

The loop runs under ``torch.no_grad()`` and not ``inference_mode()``:
the update later feeds the stored observations to the loss, and
inference tensors cannot be saved for backward.

On the hierarchical env (:class:`..env.hier.HierParams`) the
observation, mask and action are dicts of per-head tensors; the buffer
stacks them leaf by leaf.

``faults`` (flat env): the batched fault or domain schedules threaded
next to the traces; an auto-reset restarts an episode under the same
schedule. ``None`` is the healthy cluster.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..env.env import EnvParams, EnvState
from ..env.hier import env_module, vec_stepper
from ..sim.core import Trace
from . import action_dist
from .update import tree_stack

# (obs, mask) -> (masked_logits [E, A], value [E]): the policy module
PolicyApply = Callable[[torch.Tensor, torch.Tensor],
                       tuple[torch.Tensor, torch.Tensor]]
# (generator, logits) -> (i32 actions [E], log-probabilities [E])
SampleFn = Callable[[torch.Generator, torch.Tensor],
                    tuple[torch.Tensor, torch.Tensor]]


class Transition(NamedTuple):
    """The rollout buffer, ``[T, E, ...]`` (``obs``, ``action`` and
    ``mask`` are dicts of such tensors on the hierarchical env).
    ``log_prob`` is the log-prob under the behaviour policy the rollout
    ran with; PPO's ratio divides by exactly this stored value, so it is
    never recomputed."""
    obs: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    mask: torch.Tensor
    env_steps_dt: torch.Tensor  # simulated seconds advanced (metrics)


class RolloutCarry(NamedTuple):
    env_state: EnvState    # or a HierState
    obs: torch.Tensor
    mask: torch.Tensor
    generator: torch.Generator  # the sampling stream, on the env's device


def init_carry(params: EnvParams, traces: Trace,
               generator: torch.Generator, faults=None) -> RolloutCarry:
    env_state, ts = env_module(params).vec_reset(params, traces, faults)
    return RolloutCarry(env_state, ts.obs, ts.action_mask, generator)


def validate_rollout_geometry(n_steps: int, n_envs: int,
                              n_devices: int = 1) -> None:
    """Validate the rollout's batch geometry on its own terms (the env
    batch must tile the actor device group)."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if n_envs < 1:
        raise ValueError(f"n_envs must be >= 1, got {n_envs}")
    if n_devices > 1 and n_envs % n_devices:
        raise ValueError(
            f"n_envs={n_envs} must be divisible by the rollout device "
            f"group size ({n_devices}) to shard the env batch evenly")


@torch.no_grad()
def rollout(apply_fn: PolicyApply, env_params: EnvParams, traces: Trace,
            carry: RolloutCarry, n_steps: int,
            sample_fn: SampleFn = action_dist.sample, faults=None,
            ) -> tuple[RolloutCarry, Transition, torch.Tensor]:
    """Collect ``n_steps`` transitions from the batched envs. Returns
    (carry', transitions ``[T, E, ...]``, last_value ``[E]``).

    ``sample_fn`` picks the actions (default :func:`action_dist.sample`
    from the carry's generator); a test passes one that replays another
    rollout's actions."""
    # the auto-reset bundle depends only on the traces (and schedules):
    # built once here instead of a full reset every step
    fresh = env_module(env_params).vec_reset(env_params, traces, faults)
    env_step = vec_stepper(env_params, traces, faults)
    env_state, obs, mask, gen = carry
    steps = []
    for _ in range(n_steps):
        logits, value = apply_fn(obs, mask)
        action, log_prob = sample_fn(gen, logits)
        env_state, ts = env_step(env_state, action, fresh)
        steps.append(Transition(obs=obs, action=action, log_prob=log_prob,
                                value=value, reward=ts.reward, done=ts.done,
                                mask=mask, env_steps_dt=ts.info.dt))
        obs, mask = ts.obs, ts.action_mask
    transitions = tree_stack(steps)
    _, last_value = apply_fn(obs, mask)
    return RolloutCarry(env_state, obs, mask, gen), transitions, last_value
