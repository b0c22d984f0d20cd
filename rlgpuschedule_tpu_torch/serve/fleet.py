"""Fleet replay (L6) of the port: one policy against N clusters at once.

Counterpart of ``fleet_windows`` and ``fleet_replay`` in the JAX
package's ``serve/fleet.py``: the policy is replayed greedily against
``N`` seeded simulated clusters with the cluster index as the batch
axis, and the result is reported as throughput and fleet JCT. It is
:func:`..eval.replay` on the first ``N`` windows of the config's
tiling, the hierarchical config's (``n_pods > 1``) included: its
windows are validated against one pod. A flat config's clusters may
each replay under a seeded fault regime (:func:`sample_fleet_faults`,
cluster ``e`` drawing ``(seed, e)``, the chaos matrix's seeding), so a
fleet run doubles as a degraded-cluster probe.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..env.env import EnvParams, stack_traces
from ..eval import pooled_avg_jct, replay
from ..experiment import (build_env_params, load_source_trace,
                          make_env_windows, trace_sim)
from ..sim.core import Trace, validate_trace
from ..sim.faults import (fault_horizon, sample_fault_schedule,
                          stack_fault_schedules)


def fleet_windows(cfg, n_clusters: int, source=None, start: int = 0, *,
                  device: "torch.device | str | None" = None):
    """Cut ``n_clusters`` seeded trace windows (one per simulated
    cluster) from ``source`` (default: the config's validated source
    trace), the same tiling training and eval use: cluster ``e`` is
    window ``start + e``. Returns ``(windows, batched device
    traces)``."""
    if n_clusters <= 0:
        raise ValueError(f"n_clusters must be positive, got {n_clusters}")
    # the hierarchical env windows against the per-pod simulator shape
    sim_params = trace_sim(build_env_params(cfg))
    if source is None:
        source = validate_trace(sim_params, load_source_trace(cfg),
                                clamp=True)
    windows = make_env_windows(dataclasses.replace(cfg, n_envs=n_clusters),
                               source, start)
    return windows, stack_traces(windows, sim_params, device)


def sample_fleet_faults(n_nodes: int, regime: str, seed: int,
                        n_clusters: int, windows,
                        device: "torch.device | str | None" = None):
    """Seeded per-cluster fault schedules for a fleet replay, batched on
    ``device`` (default ``cuda``): cluster ``e`` draws ``(seed, e)``
    over the windows' fault horizon."""
    horizon_s = fault_horizon(windows)
    return stack_fault_schedules(
        [sample_fault_schedule(n_nodes, regime, (seed, e), horizon_s)
         for e in range(n_clusters)], device)


def fleet_replay(policy: nn.Module, env_params: EnvParams, traces: Trace,
                 max_steps: int | None = None,
                 device: "torch.device | str | None" = None,
                 faults=None) -> dict:
    """Replay ``policy`` against the whole cluster batch on ``device``
    (default ``cuda``; the traces and the policy must already be there)
    and report the pooled fleet table: ``mean_jct``
    (completion-weighted across clusters), ``completion``,
    ``decisions`` (policy decisions taken), ``decisions_per_s`` over the
    measured wall time, and the ``per_cluster`` arrays behind them.
    Preemptive configs replay with :func:`..eval.replay`'s stall guard
    on. ``faults`` (flat configs): the batched per-cluster schedules
    every cluster replays under."""
    if faults is not None and not isinstance(env_params, EnvParams):
        raise ValueError("fleet fault regimes apply to flat configs "
                         "(the hierarchical env has no fault-process "
                         "support)")
    dev = resolve_device(device)
    for what, t in (("traces", traces.submit),
                    ("policy", next(policy.parameters()))):
        if t.device.type != dev.type:
            raise ValueError(f"fleet_replay on {dev}: the {what} live on "
                             f"{t.device}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = replay(policy, env_params, traces, max_steps=max_steps,
                 faults=faults)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    mean_jct, completion = pooled_avg_jct(res)
    steps = res.steps.cpu().numpy().astype(np.int64)
    decisions = int(steps.sum())
    dps = decisions / wall if wall > 0 else 0.0
    return {
        "n_clusters": int(steps.shape[0]),
        "mean_jct": mean_jct,
        "completion": completion,
        "decisions": decisions,
        "wall_s": wall,
        "decisions_per_s": dps,
        "decisions_per_s_per_chip": dps,
        "n_chips": 1,
        "max_steps": max_steps,
        "device": str(dev),
        "per_cluster": {
            "avg_jct": [float(x) for x in res.avg_jct.cpu()],
            "n_done": [int(x) for x in res.n_done.cpu()],
            "n_valid": [int(x) for x in res.n_valid.cpu()],
            "steps": [int(x) for x in steps],
            "makespan": [float(x) for x in res.makespan.cpu()],
        },
    }
