"""Post-hoc checkpoint selection on a held-out validation stream (L6).

``python -m rlgpuschedule_tpu_torch.select_checkpoint --ckpt-dir out/run``

Counterpart of the JAX package's ``select_checkpoint.py``. Per-window
probes and the full-trace JCT are different functionals of one policy,
and neither probe regime reliably ranks full-trace quality, so the
selector scores every retained checkpoint (``train --ckpt-keep N``
retains a series) by the deliverable's own metric: the avg JCT of the
full-trace stitched replay (:func:`.eval.full_trace_replay`) over
Tiresias's, on a validation stream that is neither the training trace,
nor the in-training probe's held-out stream, nor the test stream. It
then prints the argmin. The test stream is run once afterwards with the
chosen step (``evaluate --ckpt-step``), so selection and measurement
stay disjoint.

Prints one JSON line: ``{"dir", "step", "val_ratio", "val_tiresias",
"ranking": [[ratio, step], ...]}``; the per-step lines go to stderr.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m rlgpuschedule_tpu_torch.select_checkpoint",
        description="Rank retained checkpoints by full-trace JCT on a "
                    "held-out validation stream (PyTorch, on the GPU "
                    "unless --device says otherwise).")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--config", default="ppo-mlp-synth64")
    p.add_argument("--seed", type=int, default=None,
                   help="the training seed the checkpointed run used "
                        "(train --seed); the val-seed guard checks "
                        "against this, not just the preset's")
    p.add_argument("--val-seed", type=int, default=2000,
                   help="seed of the validation stream (must differ from "
                        "the training seed, from training seed + 1000 "
                        "(the --eval-every probe's default held-out "
                        "stream) and from the test seed)")
    p.add_argument("--test-seed", type=int, default=None,
                   help="seed of the test stream the chosen step will be "
                        "measured on (evaluate's), so that the "
                        "validation/test disjointness is enforced, not "
                        "assumed")
    p.add_argument("--val-jobs", type=int, default=1024,
                   help="validation stream length in jobs")
    p.add_argument("--stitch-drain-jobs", type=int, default=8,
                   help="deep-backlog batching of the stitched replay "
                        "(selection only ranks checkpoints, so a coarse "
                        "fast stitch will do; the test run picks its own)")
    # the shape overrides of the training run (they must match the
    # checkpoints')
    p.add_argument("--n-envs", type=int, default=None)
    p.add_argument("--n-nodes", type=int, default=None)
    p.add_argument("--gpus-per-node", type=int, default=None)
    p.add_argument("--window-jobs", type=int, default=None)
    p.add_argument("--queue-len", type=int, default=None)
    p.add_argument("--horizon", type=int, default=None)
    p.add_argument("--obs-kind", default=None,
                   choices=["flat", "grid", "graph"])
    p.add_argument("--trace-load", type=float, default=None,
                   help="proxy traces: offered load of the validation "
                        "stream; match the test stream's, so that "
                        "selection happens in the deliverable's regime")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p


def main(argv: "list[str] | None" = None) -> dict:
    args = build_parser().parse_args(argv)
    from .configs import CONFIGS
    if args.config not in CONFIGS:
        sys.exit(f"unknown config {args.config!r}")
    over = {k: v for k, v in
            {"seed": args.seed, "n_envs": args.n_envs,
             "n_nodes": args.n_nodes,
             "gpus_per_node": args.gpus_per_node,
             "window_jobs": args.window_jobs, "queue_len": args.queue_len,
             "horizon": args.horizon, "obs_kind": args.obs_kind,
             "trace_load": args.trace_load}.items()
            if v is not None}
    cfg = dataclasses.replace(CONFIGS[args.config], **over)
    if cfg.trace in ("philly", "pai"):
        sys.exit("csv traces have no seeded held-out stream (the loader "
                 "would re-read the training csv, the same no-op train "
                 "refuses for --eval-seed); select against a generated "
                 "validation stream or split the csv yourself")
    if args.val_seed == cfg.seed:
        sys.exit("--val-seed equals the config's training seed; selection "
                 "on the training distribution is not validation")
    if args.val_seed == cfg.seed + 1000:
        sys.exit("--val-seed equals training seed + 1000, the in-training "
                 "--eval-every probe's default held-out seed; a --keep-best "
                 "run already optimized checkpoint choice against that "
                 "stream, so selecting on it is not validation either")
    if args.test_seed is not None:
        if args.test_seed == args.val_seed:
            sys.exit("--test-seed equals --val-seed; selection and "
                     "measurement must run on disjoint streams")
        if args.test_seed == cfg.seed:
            sys.exit("--test-seed equals the config's training seed; "
                     "measuring on the training distribution is not a "
                     "test")

    from . import eval as eval_lib
    from .checkpoint import Checkpointer
    from .experiment import Experiment, load_source_trace
    from .sim.core import validate_trace
    from .sim.schedulers import run_baseline

    try:
        exp = Experiment.build(cfg, device=args.device)
    except (NotImplementedError, ValueError) as e:
        sys.exit(str(e))
    val = validate_trace(
        exp.env_params.sim,
        load_source_trace(cfg, n_jobs=args.val_jobs, seed=args.val_seed),
        clamp=True)
    tiresias = run_baseline(val, cfg.n_nodes, cfg.gpus_per_node,
                            "tiresias").avg_jct()
    rows = []
    with Checkpointer(os.path.abspath(args.ckpt_dir)) as ck:
        steps = ck.all_steps()
        if not steps:
            sys.exit(f"no checkpoints under {args.ckpt_dir}")
        for step in steps:
            exp.restore_checkpoint(ck, step=step, train=False)
            out = eval_lib.full_trace_replay(
                exp.net, exp.env_params, val,
                drain_completions=args.stitch_drain_jobs)
            ratio = out["avg_jct"] / tiresias
            rows.append((round(ratio, 4), step))
            print(f"step {step}: {out['avg_jct']:.1f} ratio {ratio:.4f} "
                  f"({out['windows']} windows)", file=sys.stderr,
                  flush=True)
    best = min(rows)
    result = {"dir": args.ckpt_dir, "step": best[1], "val_ratio": best[0],
              "val_tiresias": round(tiresias, 1), "ranking": sorted(rows)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
