"""Named experiment configs (L6): cluster, trace, env and PPO fields.

The port's copy of the JAX package's ``configs.py``. The ``a2c``
optimizer fields, fault and domain regimes and the mode-refusal table
wait for their slices.
The presets keep their names and the values of the fields kept here, so
a config name means the same run in both packages; the presets this
port cannot run are refused by :func:`..experiment.build_env_params`
and :meth:`..experiment.Experiment.build`.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

from .algos.ppo import PPOConfig


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    algo: Literal["ppo", "a2c"] = "ppo"   # "a2c" waits for config 3
    # cluster
    n_nodes: int = 8
    gpus_per_node: int = 8
    # trace source: "synthetic" (Poisson), "philly-proxy"/"pai-proxy"
    # (seeded traces with the published Philly/PAI statistics), or
    # "philly"/"pai", a real CSV at trace_path
    trace: Literal["synthetic", "philly", "pai",
                   "philly-proxy", "pai-proxy"] = "synthetic"
    trace_path: str | None = None
    trace_load: float = 1.1             # proxy traces: offered load target
    # generated traces: pin the source trace size in jobs; None = one
    # window-streaming pass over the env batch (window_jobs *
    # max(n_envs, 8), floored at 1024 / 4096)
    source_jobs: int | None = None
    # window streaming: every N iterations re-cut the env windows at the
    # next n_envs windows of the source tiling (0 = static windows)
    resample_every: int = 0
    arrival_rate: float = 0.08          # synthetic: jobs/sec
    mean_duration: float = 600.0        # synthetic: log-normal mean
    window_jobs: int = 64               # jobs per episode window (max_jobs)
    # backlog-drain curriculum: the last round(n_envs * drain_frac) envs
    # train on copies of their windows with every job submitted at t=0
    drain_frac: float = 0.0
    # env
    n_envs: int = 4
    queue_len: int = 8
    n_placements: int = 1
    preempt_len: int = 0                # >0 = preemptive RL action space
    n_pods: int = 1                     # >1 = hierarchical env (config 5)
    obs_kind: Literal["flat", "grid", "graph"] = "flat"
    reward_kind: Literal["jct", "fair"] = "jct"
    n_tenants: int = 1
    nodes_per_rack: int | None = None   # graph topology granularity
    horizon: int = 512
    time_scale: float = 600.0
    reward_scale: float = 10_000.0
    place_bonus: float = 0.05
    # preemptive configs: the reward's charge per preemption and per
    # re-placement (env/rewards.py::preempt_charge); exactly -0.0 on a
    # non-preemptive action space
    preempt_cost: float = 0.25
    # training
    ppo: PPOConfig = PPOConfig()
    iterations: int = 100
    seed: int = 0

    @property
    def total_gpus(self) -> int:
        return self.n_nodes * self.gpus_per_node


def repro_tuple(cfg: ExperimentConfig, ckpt_dir: str | None = None,
                ckpt_step: int | None = None) -> dict:
    """The reproducibility tuple every evaluate and serve JSON carries:
    the config fields that determine a replay and the checkpoint it
    restored, the JAX package's key set. ``ckpt_step`` is the step
    actually restored (``Checkpointer.last_restored_step``), which the
    integrity fallback may make older than the one asked for. The port
    has no fault or domain regimes yet: ``faults`` and ``domains`` are
    None."""
    return {"config": cfg.name, "seed": cfg.seed, "trace": cfg.trace,
            "trace_path": cfg.trace_path, "trace_load": cfg.trace_load,
            "source_jobs": cfg.source_jobs, "n_envs": cfg.n_envs,
            "n_nodes": cfg.n_nodes, "gpus_per_node": cfg.gpus_per_node,
            "window_jobs": cfg.window_jobs, "queue_len": cfg.queue_len,
            "horizon": cfg.horizon, "obs_kind": cfg.obs_kind,
            "drain_frac": cfg.drain_frac, "faults": None, "domains": None,
            "ckpt_dir": ckpt_dir, "ckpt_step": ckpt_step}


CONFIGS: dict[str, ExperimentConfig] = {}


def _register(cfg: ExperimentConfig) -> ExperimentConfig:
    CONFIGS[cfg.name] = cfg
    return cfg


# 1. PPO-MLP scheduler, 64-GPU synthetic Poisson trace, 4 envs.
PPO_MLP_SYNTH64 = _register(ExperimentConfig(
    name="ppo-mlp-synth64", n_nodes=8, gpus_per_node=8,
    trace="synthetic", n_envs=4, obs_kind="flat"))

# 2. PPO-CNN, 512-GPU cluster on the Philly-statistics proxy trace.
PPO_CNN_PHILLY512 = _register(ExperimentConfig(
    name="ppo-cnn-philly512", n_nodes=64, gpus_per_node=8,
    trace="philly-proxy", n_envs=8, obs_kind="grid", window_jobs=128,
    queue_len=16, horizon=1024))

# 3. A2C on the PAI proxy trace with the multi-tenant fairness reward.
A2C_PAI_FAIR = _register(ExperimentConfig(
    name="a2c-pai-fair", algo="a2c", n_nodes=16, gpus_per_node=8,
    trace="pai-proxy", n_envs=16, obs_kind="flat", reward_kind="fair",
    n_tenants=8, window_jobs=96))

# 4. GNN policy over cluster topology, gang-scheduling + placement.
GNN_GANG_PLACE = _register(ExperimentConfig(
    name="gnn-gang-place", n_nodes=16, gpus_per_node=8,
    trace="synthetic", n_envs=4, obs_kind="graph", n_placements=2,
    nodes_per_rack=4, window_jobs=64))

# Preemptive variant of config 1.
PPO_MLP_PREEMPT = _register(ExperimentConfig(
    name="ppo-mlp-preempt", n_nodes=8, gpus_per_node=8,
    trace="synthetic", n_envs=4, obs_kind="flat", preempt_len=4))

# 5. Hierarchical multi-agent across 4 pods (a PBT population member).
HIER_PBT_MEMBER = _register(ExperimentConfig(
    name="hier-pbt-member", n_nodes=16, gpus_per_node=8,
    n_pods=4, trace="synthetic", n_envs=4, obs_kind="flat",
    window_jobs=64))
