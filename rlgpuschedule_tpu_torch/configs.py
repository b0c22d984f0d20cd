"""Named experiment configs (L6): cluster, trace, env, PPO and A2C
fields, and the mode-combination refusal table.

The port's copy of the JAX package's ``configs.py``, the fault and
domain regimes (``faults``, ``domains``) included. The presets keep
their names and the values of the fields kept here, so a config name
means the same run in both packages; every preset runs, the
hierarchical config 5
(``hier-pbt-member``, ``n_pods > 1``) through :mod:`.env.hier`.
:data:`MODE_REFUSALS` is JAX's table word for word, so a refused pair
gives the JAX CLI's message; modes that wait for a slice of the port are
refused before it, by the CLIs' tables of unported flags.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

from .algos.a2c import A2CConfig
from .algos.ppo import PPOConfig


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    algo: Literal["ppo", "a2c"] = "ppo"
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
    a2c: A2CConfig = A2CConfig()
    iterations: int = 100
    seed: int = 0
    # cluster chaos: train under seeded per-env fault schedules drawn
    # from this named regime (sim.faults.FAULT_REGIMES); a flat config's
    # observation gains per-node health. None = a healthy cluster
    faults: str | None = None
    # domain randomization: per-env cluster geometry, hardware speed and
    # arrival draws from this named regime (domains.DOMAIN_REGIMES),
    # composed with faults. None = the one fixed cluster
    domains: str | None = None

    @property
    def total_gpus(self) -> int:
        return self.n_nodes * self.gpus_per_node


class ModeCombinationError(ValueError):
    """Two requested run modes are mutually unsupported (the one refusal
    format of :data:`MODE_REFUSALS`)."""


# how each mode name is spelled to the user in refusal messages
MODE_FLAGS: dict[str, str] = {
    "async": "--async",
    "pbt": "--pbt",
    "faults": "--faults",
    "domains": "--domains",
    "fault_injection": "--fault",
    "fused_chunk": "--fused-chunk",
    "rollbacks": "--max-rollbacks",
    "hier": "hierarchical config (n_pods > 1)",
    "shard_map": "shard_map/axis_name build",
    "mesh": "--mesh",
    "vtrace": "--correction vtrace",
    "sync": "the synchronous loop (no --async)",
    "router": "--engines > 1 (multi-engine serving router)",
    "continual": "--continual LOGDIR (flight-log retraining)",
}

# every pairwise refusal, symmetric: (mode_a, mode_b, why)
MODE_REFUSALS: tuple[tuple[str, str, str], ...] = (
    ("vtrace", "sync",
     "importance correction divides the target policy by the behavior "
     "policy; the sync loop collects every batch on-policy (ratios are "
     "identically 1), so --correction vtrace without --async would only "
     "buy the extra forward pass — the bit-identity contract makes this "
     "a no-op, refuse it loudly instead"),
    ("vtrace", "hier",
     "the hierarchical joint log-prob sums router+placer heads; the "
     "V-trace ratio recompute has not been validated against the "
     "multi-head action distribution yet"),
    ("async", "fused_chunk",
     "the async engine already overlaps phases — pick one"),
    ("async", "rollbacks",
     "the divergence watchdog is sync-path-only for now"),
    ("async", "fault_injection",
     "fault injection hooks the sync loop's iteration boundary"),
    ("async", "mesh",
     "the async engine resolves its own actor/learner submeshes from "
     "the unified mesh"),
    ("pbt", "domains",
     "per-member domain draws would need member-indexed trace windows "
     "through the population stack; sample domain diversity across "
     "single-run seeds instead"),
    ("hier", "domains",
     "domain schedules carry per-node capacity through the flat sim "
     "path only; the pod-sharded hierarchical env has no geometry "
     "threading yet"),
    ("pbt", "fused_chunk",
     "the PBT loop interleaves host-side exploit/explore between steps"),
    ("pbt", "mesh",
     "--pbt builds the population mesh from the unified mesh "
     "automatically"),
    ("hier", "faults",
     "sim faults thread per-node health through flat observations only"),
    ("shard_map", "pbt",
     "the population step is a GSPMD vmap, not an axis-name program"),
    ("shard_map", "async",
     "the async engine jits per-group GSPMD programs, not shard_map"),
    ("shard_map", "fused_chunk",
     "run_fused jits the raw step; an axis-name step needs "
     "dp.shard_map_train"),
    ("shard_map", "mesh",
     "rule-table shardings are GSPMD in/out_shardings; the axis-name "
     "path wires its own specs in dp.shard_map_train"),
    ("router", "hier",
     "the engine router resolves one single-device engine per data-axis "
     "device; a hierarchical (n_pods > 1) policy's router+placer heads "
     "have not been validated under per-engine replicated serving — "
     "serve hierarchical configs single-engine until they are"),
    ("continual", "pbt",
     "continual ingest folds ONE flight log into one learner's "
     "pseudo-trajectories; a population would train every member on "
     "the same behavior stream (no per-member exploration signal)"),
    ("continual", "async",
     "the async engine overlaps simulator rollout collection with the "
     "update; continual mode has no rollout to overlap — the flight "
     "log is read once up front"),
    ("continual", "hier",
     "logged rows carry the flat policy's action heads; the "
     "hierarchical joint log-prob has not been validated against "
     "flight-log replay (same gap as vtrace x hier)"),
    ("continual", "fused_chunk",
     "run_fused scans the simulator train step; continual updates run "
     "their own jitted learn step over a fixed ingested batch"),
)


def _validate_refusal_table() -> None:
    """Checked at import: a misspelled mode name would otherwise never
    refuse anything."""
    for a, b, why in MODE_REFUSALS:
        for m in (a, b):
            if m not in MODE_FLAGS:
                raise AssertionError(
                    f"MODE_REFUSALS names unknown mode {m!r} (known: "
                    f"{sorted(MODE_FLAGS)})")
        if a == b or not why:
            raise AssertionError(f"malformed refusal entry {(a, b, why)!r}")


_validate_refusal_table()


def validate_mode_combination(active: dict[str, bool]) -> None:
    """Raise :class:`ModeCombinationError` if two active modes are a
    refused pair. ``active`` maps :data:`MODE_FLAGS` names to whether
    the run asks for them; an unknown name raises ``KeyError``."""
    unknown = set(active) - set(MODE_FLAGS)
    if unknown:
        raise KeyError(f"unknown mode name(s) {sorted(unknown)}; known: "
                       f"{sorted(MODE_FLAGS)}")
    for a, b, why in MODE_REFUSALS:
        if active.get(a) and active.get(b):
            raise ModeCombinationError(
                f"unsupported mode combination: {MODE_FLAGS[a]} × "
                f"{MODE_FLAGS[b]} — {why}")


def repro_tuple(cfg: ExperimentConfig, ckpt_dir: str | None = None,
                ckpt_step: int | None = None) -> dict:
    """The reproducibility tuple every evaluate and serve JSON carries:
    the config fields that determine a replay and the checkpoint it
    restored, the JAX package's key set. ``ckpt_step`` is the step
    actually restored (``Checkpointer.last_restored_step``), which the
    integrity fallback may make older than the one asked for."""
    return {"config": cfg.name, "seed": cfg.seed, "trace": cfg.trace,
            "trace_path": cfg.trace_path, "trace_load": cfg.trace_load,
            "source_jobs": cfg.source_jobs, "n_envs": cfg.n_envs,
            "n_nodes": cfg.n_nodes, "gpus_per_node": cfg.gpus_per_node,
            "window_jobs": cfg.window_jobs, "queue_len": cfg.queue_len,
            "horizon": cfg.horizon, "obs_kind": cfg.obs_kind,
            "drain_frac": cfg.drain_frac, "faults": cfg.faults,
            "domains": cfg.domains,
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
