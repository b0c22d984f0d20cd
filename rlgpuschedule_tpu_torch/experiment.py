"""Experiment assembly (L6) of the port: config -> traces, env, policy,
optimizer and the training loop.

Counterparts of ``build_env_params``, ``load_source_trace``,
``build_stack``, ``windows_per_pass``, ``make_env_windows`` and the
single-run ``Experiment`` (``build``, ``run`` with its eval hook,
``steps_per_iteration``) in the JAX package's ``experiment.py``.
Checkpoints, window streaming, ``run_fused``, meshes, faults and
domains are not ported; the hierarchical config and A2C are refused
here with ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from .algos.ppo import (PPOMetrics, TrainState, make_train_state,
                        make_train_step)
from .algos.rollout import (RolloutCarry, init_carry,
                            validate_rollout_geometry)
from .algos.update import validate_update_geometry
from .configs import ExperimentConfig
from .device import resolve_device
from .env.env import EnvParams, stack_traces
from .env.obs import build_adjacency
from .models import ActorCritic, GNNActorCritic, make_policy
from .sim.core import SimParams, Trace, validate_trace
from .traces import (ArrayTrace, gen_pai_proxy_trace, gen_philly_proxy_trace,
                     gen_poisson_trace, load_pai, load_philly)


def build_env_params(cfg: ExperimentConfig) -> EnvParams:
    if cfg.n_pods > 1:
        raise NotImplementedError(
            f"config {cfg.name!r} has n_pods={cfg.n_pods}: the "
            f"hierarchical env (hier-pbt-member) waits for the config-5 "
            f"slice")
    sim = SimParams(n_nodes=cfg.n_nodes, gpus_per_node=cfg.gpus_per_node,
                    max_jobs=cfg.window_jobs, queue_len=cfg.queue_len,
                    n_placements=cfg.n_placements,
                    preempt_len=cfg.preempt_len)
    return EnvParams(sim=sim, obs_kind=cfg.obs_kind,
                     reward_kind=cfg.reward_kind,
                     time_scale=cfg.time_scale,
                     reward_scale=cfg.reward_scale,
                     place_bonus=cfg.place_bonus,
                     preempt_cost=cfg.preempt_cost, horizon=cfg.horizon)


def load_source_trace(cfg: ExperimentConfig) -> ArrayTrace:
    """The full source trace this experiment schedules: generated from
    ``cfg.seed`` for the synthetic and proxy traces, sized by
    ``cfg.source_jobs``; read from ``cfg.trace_path`` for the CSV
    traces."""
    # source_jobs pins generated traces only; a CSV is its own size
    if cfg.trace == "synthetic":
        n = cfg.source_jobs or max(cfg.window_jobs * max(cfg.n_envs, 8),
                                   1024)
        return gen_poisson_trace(cfg.arrival_rate, n, cfg.seed,
                                 mean_duration=cfg.mean_duration,
                                 n_tenants=max(cfg.n_tenants, 1))
    if cfg.trace in ("philly-proxy", "pai-proxy"):
        n = cfg.source_jobs or max(cfg.window_jobs * max(cfg.n_envs, 8),
                                   4096)
        gen = (gen_philly_proxy_trace if cfg.trace == "philly-proxy"
               else gen_pai_proxy_trace)
        kw = {"n_tenants": cfg.n_tenants} if cfg.n_tenants else {}
        return gen(n, cfg.seed, n_gpus=cfg.total_gpus, load=cfg.trace_load,
                   max_gang=cfg.total_gpus, **kw)
    if cfg.trace_path is None:
        raise ValueError(
            f"config {cfg.name!r} uses trace={cfg.trace!r} but has no "
            f"trace_path; pass one (CSV) or use trace='synthetic'")
    loader = load_philly if cfg.trace == "philly" else load_pai
    return loader(cfg.trace_path)


def windows_per_pass(total_jobs: int, window_jobs: int) -> int:
    """Windows in one full tiling pass over the trace (the last window is
    the final ``window_jobs`` jobs, so every job is in some window)."""
    return max(-(-total_jobs // window_jobs), 1)


def make_env_windows(cfg: ExperimentConfig, source: ArrayTrace,
                     start: int = 0) -> list[ArrayTrace]:
    """Cut ``n_envs`` episode windows out of the source trace: windows
    ``start + e`` of a tiling of the trace by ``window_jobs``, wrapping
    around at its end."""
    total = source.num_jobs
    if total < cfg.window_jobs:
        raise ValueError(f"source trace has {total} jobs < window "
                         f"{cfg.window_jobs}")
    per_pass = windows_per_pass(total, cfg.window_jobs)
    windows = []
    for e in range(cfg.n_envs):
        k = (start + e) % per_pass
        off = min(k * cfg.window_jobs, total - cfg.window_jobs)
        windows.append(source.slice(off, cfg.window_jobs))
    return windows


def build_policy(cfg: ExperimentConfig, env_params: EnvParams, *,
                 dtype: torch.dtype = torch.bfloat16,
                 device: "torch.device | str | None" = None,
                 ) -> "ActorCritic | GNNActorCritic":
    """The config's actor-critic, seeded ``cfg.seed``, on ``device``; a
    graph config's holds the adjacency of ``build_adjacency(n_nodes,
    queue_len, nodes_per_rack, preempt_len)``."""
    kw = {}
    if cfg.obs_kind == "graph":
        kw = dict(adjacency=build_adjacency(cfg.n_nodes, cfg.queue_len,
                                            cfg.nodes_per_rack,
                                            cfg.preempt_len),
                  n_cluster_nodes=cfg.n_nodes, queue_len=cfg.queue_len,
                  n_placements=cfg.n_placements,
                  preempt_len=cfg.preempt_len)
    return make_policy(cfg.obs_kind, env_params.n_actions,
                       env_params.obs_shape(), dtype=dtype, seed=cfg.seed,
                       device=device, **kw)


def build_stack(cfg: ExperimentConfig,
                device: "torch.device | str | None" = None):
    """Trace load/validate/window/stack and the policy, on ``device``
    (default ``cuda``). Returns ``(env_params, windows, traces [E, ...],
    net, source)``; ``net(obs, mask)`` is the apply function (a graph
    policy holds its adjacency) and ``source`` the full validated source
    trace."""
    env_params = build_env_params(cfg)
    source = validate_trace(env_params.sim, load_source_trace(cfg),
                            clamp=True)
    windows = make_env_windows(cfg, source)
    traces = stack_traces(windows, env_params, device)
    net = build_policy(cfg, env_params, device=device)
    return env_params, windows, traces, net, source


@dataclasses.dataclass
class Experiment:
    """An assembled PPO run: the train step and its host loop."""
    cfg: ExperimentConfig
    env_params: EnvParams
    windows: list            # host ArrayTrace windows
    traces: Trace            # batched device traces [E, ...]
    train_state: TrainState  # policy + optimizer, updated in place
    train_step: Callable
    carry: RolloutCarry      # env state, obs, mask, sampling generator
    generator: torch.Generator   # the update's permutation stream
    source: ArrayTrace
    device: torch.device

    @property
    def net(self) -> "ActorCritic | GNNActorCritic":
        return self.train_state.net

    @staticmethod
    def build(cfg: ExperimentConfig,
              device: "torch.device | str | None" = None) -> "Experiment":
        """Policy from ``cfg.seed``, optimizer, first env reset. The
        rollout samples from a generator seeded ``cfg.seed`` and the
        update permutes with one seeded ``cfg.seed + 1``, both on
        ``device``."""
        dev = resolve_device(device)
        if cfg.algo != "ppo":
            raise NotImplementedError(
                f"config {cfg.name!r} trains with algo={cfg.algo!r}: A2C "
                f"(a2c-pai-fair) waits for the config-3 slice (ROADMAP.md "
                f"queue 1, item 16)")
        ppo = cfg.ppo
        # fail fast on a geometry that cannot tile the rollout batch
        validate_rollout_geometry(ppo.n_steps, cfg.n_envs)
        validate_update_geometry(ppo.n_epochs, ppo.n_minibatches,
                                 ppo.minibatch_size, n_steps=ppo.n_steps,
                                 n_envs=cfg.n_envs)
        env_params, windows, traces, net, source = build_stack(cfg, dev)
        carry = init_carry(env_params, traces,
                           torch.Generator(dev).manual_seed(cfg.seed))
        return Experiment(
            cfg=cfg, env_params=env_params, windows=windows, traces=traces,
            train_state=make_train_state(net, ppo),
            train_step=make_train_step(env_params, ppo), carry=carry,
            generator=torch.Generator(dev).manual_seed(cfg.seed + 1),
            source=source, device=dev)

    @property
    def steps_per_iteration(self) -> int:
        return self.cfg.ppo.n_steps * self.cfg.n_envs

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, iterations: int | None = None, log_every: int = 0,
            logger: Callable[[int, dict], None] | None = None,
            eval_every: int = 0,
            eval_fn: "Callable[[int], dict] | None" = None,
            eval_logger: Callable[[int, dict], None] | None = None,
            ) -> dict:
        """Run the training loop; returns the summary (wall time, env
        steps per second, logged history). Iteration ``i`` is logged
        when ``i % log_every == 0`` and at the last iteration; a logged
        iteration costs one host sync (its metrics in one transfer).

        ``eval_fn(i) -> dict`` runs after iteration ``i`` when
        ``(i + 1) % eval_every == 0`` and at the last iteration (the
        in-training quality probe, e.g. a held-out JCT replay); its rows
        go to ``eval_logger`` and into the summary's ``eval_history``.
        Nothing else in the loop waits for the device. ``wall_s`` and
        env-steps/s include the probes' time."""
        iterations = iterations or self.cfg.iterations
        history, eval_history = [], []
        self._sync()
        t0 = time.perf_counter()
        for i in range(iterations):
            self.train_state, self.carry, metrics = self.train_step(
                self.train_state, self.carry, self.traces, self.generator)
            if log_every and (i % log_every == 0 or i == iterations - 1):
                m = dict(zip(PPOMetrics._fields,
                             torch.stack(metrics).tolist()))
                history.append({"iteration": i, **m})
                if logger is not None:
                    logger(i, m)
            if eval_fn is not None and eval_every and \
                    ((i + 1) % eval_every == 0 or i == iterations - 1):
                em = dict(eval_fn(i))
                eval_history.append({"iteration": i, **em})
                if eval_logger is not None:
                    eval_logger(i, em)
        self._sync()
        wall = time.perf_counter() - t0
        env_steps = iterations * self.steps_per_iteration
        out = {"wall_s": wall, "iterations": iterations,
               "env_steps": env_steps,
               "env_steps_per_sec": env_steps / wall,
               "history": history}
        if eval_history:
            out["eval_history"] = eval_history
        return out
