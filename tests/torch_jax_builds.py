"""The JAX package's reference objects for the port's parity tests, built
without the eager paths that dominate a cold CPU test run.

``Experiment.build`` of the JAX package initializes the policy with an
eager ``net.init`` and resets the envs with an eager ``vmap``: on the CPU
both compile op by op, several seconds per build before any program the
test compares has run. :func:`fast_jax_build` builds the same experiment
with those two calls jitted (the same functions, the same key, so the
same parameters and carry up to XLA's fusion of the f32 arithmetic, which
the parity tests hold the port to anyway); :func:`jax_view` builds only
what the JAX reports read of an experiment; :func:`jitted_env` runs the
JAX env's batched reset and step jitted where its serving helpers call
them eagerly.
"""
from __future__ import annotations

import contextlib
import types

import jax
import numpy as np
import pytest

from rlgpuschedule_tpu import experiment as jexp
from rlgpuschedule_tpu.algos import ppo as jppo
from rlgpuschedule_tpu.env import env as jenv
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu.sim.core import validate_trace as jvalidate


def _jitted_train_state(net, key, example_obs, example_mask, tx,
                        extra_apply_args=(), reward_norm=False):
    """``algos.ppo.make_train_state`` with the ``net.init`` jitted."""
    params = jax.jit(lambda k, o, m, *x: net.init(k, o, *x, m))(
        key, example_obs, example_mask, *extra_apply_args)
    if reward_norm:
        return jppo.NormTrainState.create(
            apply_fn=net.apply, params=params, tx=tx,
            reward_stats=jppo.init_reward_stats())
    return jppo.TrainState.create(apply_fn=net.apply, params=params, tx=tx)


def _jitted_init_carry(params, traces, key, faults=None):
    return _JIT_CARRY(params, traces, key, faults)


_JIT_CARRY = jax.jit(jexp.init_carry, static_argnums=(0,))


@contextlib.contextmanager
def jitted_reference():
    """Within: the JAX ``experiment`` module's policy init and env reset
    (``make_train_state``, ``init_carry``) run jitted."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jexp, "make_train_state", _jitted_train_state)
        mp.setattr(jexp, "init_carry", _jitted_init_carry)
        yield


_JIT_RESET = jax.jit(jenv.vec_reset, static_argnums=(0,))
_JIT_STEP = jax.jit(jenv.vec_step, static_argnums=(0,))


@contextlib.contextmanager
def jitted_env():
    """Within: the JAX env module's ``vec_reset`` and ``vec_step`` run
    jitted (its serving helpers call them eagerly, op by op)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenv, "vec_reset", lambda params, *a, **k: _JIT_RESET(
            params, *a, **k))
        mp.setattr(jenv, "vec_step", lambda params, *a, **k: _JIT_STEP(
            params, *a, **k))
        yield


def fast_jax_build(cfg, **kw):
    """``Experiment.build(cfg, **kw)`` of the JAX package with its
    policy init and its first env reset jitted."""
    with jitted_reference():
        return jexp.Experiment.build(cfg, **kw)


def jax_view(cfg_j, dtype=None):
    """What the JAX package's reports read of an ``Experiment`` (config,
    env, windows, traces, source, policy), built by its own functions as
    ``Experiment.build`` builds them, less the train state and the
    rollout carry. The policy is the net in ``dtype`` (default f32) with
    the weights ``Experiment.build`` initializes from ``cfg.seed``."""
    import jax.numpy as jnp
    jp = jexp.build_env_params(cfg_j)
    source = jvalidate(jp.sim, jexp.load_source_trace(cfg_j), clamp=True)
    windows = jexp.make_env_windows(cfg_j, source)
    net = jmake_policy(cfg_j.obs_kind, jp.n_actions,
                       dtype=dtype or jnp.float32)
    _, init_key, _ = jax.random.split(jax.random.PRNGKey(cfg_j.seed), 3)
    params = jax.device_get(jax.jit(net.init)(
        init_key, np.zeros((1,) + jp.obs_shape(), np.float32),
        np.ones((1, jp.n_actions), bool)))
    return types.SimpleNamespace(
        cfg=cfg_j, env_params=jp, windows=windows,
        traces=jenv.stack_traces(windows, jp), source=source,
        apply_fn=net.apply, train_state=types.SimpleNamespace(params=params))
