"""Experiment assembly (L6) of the port: config -> env params and trace
windows.

Counterparts of ``build_env_params``, ``load_source_trace``,
``windows_per_pass`` and ``make_env_windows`` in the JAX package's
``experiment.py``. The ``Experiment`` class (policy, optimizer, train
loop) waits for the training slice. Configs outside this slice's
simulator subset are refused here with ``NotImplementedError``.
"""
from __future__ import annotations

from .configs import ExperimentConfig
from .env.env import EnvParams
from .sim.core import SimParams
from .traces import ArrayTrace, gen_philly_proxy_trace, gen_poisson_trace


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
                     place_bonus=cfg.place_bonus, horizon=cfg.horizon)


def load_source_trace(cfg: ExperimentConfig) -> ArrayTrace:
    """The full source trace this experiment schedules (generated from
    the config's seed)."""
    seed, n_jobs = cfg.seed, cfg.source_jobs
    if cfg.trace == "synthetic":
        n = n_jobs or max(cfg.window_jobs * max(cfg.n_envs, 8), 1024)
        return gen_poisson_trace(cfg.arrival_rate, n, seed,
                                 mean_duration=cfg.mean_duration,
                                 n_tenants=max(cfg.n_tenants, 1))
    if cfg.trace == "philly-proxy":
        n = n_jobs or max(cfg.window_jobs * max(cfg.n_envs, 8), 4096)
        kw = {"n_tenants": cfg.n_tenants} if cfg.n_tenants else {}
        return gen_philly_proxy_trace(n, seed, n_gpus=cfg.total_gpus,
                                      load=cfg.trace_load,
                                      max_gang=cfg.total_gpus, **kw)
    raise NotImplementedError(
        f"config {cfg.name!r} uses trace={cfg.trace!r}: the PAI proxy "
        f"and the Philly/PAI CSV loaders wait for a later trace slice")


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
