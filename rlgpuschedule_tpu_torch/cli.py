"""Flags and output the train and evaluate CLIs share: the cluster,
trace and observation overrides, the refusal of the JAX CLIs' flags the
port does not take, and the JSON-ready part of a JCT report."""
from __future__ import annotations

import argparse
import sys

from .configs import ExperimentConfig


def add_config_flags(p: argparse.ArgumentParser) -> None:
    """The cluster, trace and observation overrides the train and
    evaluate CLIs share (None = keep the preset's value)."""
    p.add_argument("--n-nodes", type=int, default=None)
    p.add_argument("--gpus-per-node", type=int, default=None)
    p.add_argument("--window-jobs", type=int, default=None)
    p.add_argument("--queue-len", type=int, default=None,
                   help="pending-queue slots the agent sees and acts on")
    p.add_argument("--horizon", type=int, default=None)
    p.add_argument("--obs-kind", default=None,
                   choices=["flat", "grid", "graph"],
                   help="observation/encoder family: flat (MLP), grid "
                        "(CNN) or graph (GNN over the topology graph)")
    p.add_argument("--trace", default=None,
                   choices=["synthetic", "philly", "pai", "philly-proxy",
                            "pai-proxy"],
                   help="trace source (e.g. switch a -proxy preset to the "
                        "real CSV loader)")
    p.add_argument("--trace-path", default=None,
                   help="CSV path for philly/pai traces")
    p.add_argument("--trace-load", type=float, default=None,
                   help="proxy traces: offered-load target (default 1.1)")
    p.add_argument("--source-jobs", type=int, default=None,
                   help="generated traces: pin the source trace size in "
                        "jobs (default: one pass over the env batch)")


def config_overrides(args: argparse.Namespace) -> dict:
    """The fields :func:`add_config_flags` set (and ``--seed``,
    ``--n-envs``), for ``dataclasses.replace``."""
    fields = {"seed": args.seed, "n_envs": args.n_envs,
              "n_nodes": args.n_nodes, "gpus_per_node": args.gpus_per_node,
              "window_jobs": args.window_jobs, "horizon": args.horizon,
              "queue_len": args.queue_len, "obs_kind": args.obs_kind,
              "trace": args.trace, "trace_path": args.trace_path,
              "trace_load": args.trace_load,
              "source_jobs": args.source_jobs}
    return {k: v for k, v in fields.items() if v is not None}


def check_source_jobs(args: argparse.Namespace,
                      cfg: ExperimentConfig) -> None:
    """Exit on a ``--source-jobs`` that is invalid or a silent no-op."""
    if args.source_jobs is not None:
        if args.source_jobs <= 0:
            sys.exit("--source-jobs must be positive")
        if cfg.trace in ("philly", "pai"):
            sys.exit("--source-jobs sizes GENERATED traces; a CSV trace "
                     "is its file's own size (refusing the silent no-op)")


def refuse_unported(extra: list[str], parser: argparse.ArgumentParser,
                    unported: dict[str, str]) -> None:
    """Exit naming the slice an unported flag of the JAX CLI waits for;
    argparse's error for any other unknown argument."""
    for tok in extra:
        flag = tok.split("=", 1)[0]
        if flag in unported:
            sys.exit(f"{flag} is not in the PyTorch port yet: it waits for "
                     f"{unported[flag]}")
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")


def numeric_rows(report: dict) -> dict:
    """A JCT report's JSON-ready part: its numbers, the baseline backend
    and the wall-time split."""
    out = {k: v for k, v in report.items() if isinstance(v, (int, float))}
    for k in ("baseline_backend", "wall_s"):
        if k in report:
            out[k] = report[k]
    return out
