"""Evaluation CLI (L6) of the port:
``python -m rlgpuschedule_tpu_torch.evaluate --config <name>``.

Counterpart of the per-window table of the JAX package's
``evaluate.py``: it builds the config's experiment on the device,
replays its trace windows under the greedy policy and the masked-uniform
random control there, runs the FIFO, SJF, SRTF and Tiresias baselines
over the same windows on the host (:func:`..eval.jct_report`), prints
the table on stderr and one JSON line on stdout: the numeric rows,
``percentiles`` with ``--percentiles``, the baseline backend, the wall
time of each part, the device, and a ``repro`` block of the config
fields that regenerate it.

There are no checkpoints in the port yet, so the policy is the seeded
init of ``--seed`` (said on stderr). Every other flag of the JAX CLI
exits naming the slice it waits for.

Examples::

    python -m rlgpuschedule_tpu_torch.evaluate --config ppo-cnn-philly512 \\
        --eval-windows 8 --max-steps 4096 --percentiles
    python -m rlgpuschedule_tpu_torch.evaluate --config ppo-mlp-synth64 \\
        --baselines-only --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from .cli import (add_config_flags, check_source_jobs, config_overrides,
                  numeric_rows, refuse_unported)
from .configs import CONFIGS, repro_tuple
from .device import resolve_device
from .eval import baseline_jct_table, format_report, jct_report
from .experiment import (Experiment, build_env_params, load_source_trace,
                         make_env_windows)
from .sim.core import validate_trace

# tail-latency columns --percentiles adds (keep the flag's help in sync)
PERCENTILES = (50, 90, 99)

_Q1 = "ROADMAP.md queue 1"
_FULL_TRACE = f"the full-trace stitched replay ({_Q1}, item 11)"
# the JAX CLI's flags that this port does not take, and what they wait for
UNPORTED_FLAGS: dict[str, str] = {
    **dict.fromkeys(("--ckpt-dir", "--ckpt-step"),
                    f"the checkpoint slice ({_Q1}, item 12)"),
    **dict.fromkeys(("--full-trace", "--max-jobs", "--stitch-window-jobs",
                     "--stitch-drain-jobs", "--stitch-faults",
                     "--stitch-domain", "--stitch-seed"), _FULL_TRACE),
    **dict.fromkeys(
        ("--chaos", "--chaos-regimes", "--chaos-baselines", "--chaos-seed",
         "--matrix", "--matrix-regimes", "--matrix-baselines",
         "--matrix-seed", "--matrix-ckpt", "--faults", "--domains"),
        f"the chaos and domain slice ({_Q1}, item 17)"),
    "--fairness": f"the fairness slice ({_Q1}, item 16)",
    **dict.fromkeys(("--pbt", "--n-pop", "--member"),
                    f"the hierarchical/PBT slice ({_Q1}, item 19)"),
    "--drain-frac": f"window streaming and the drain curriculum ({_Q1}, "
                    f"item 13)",
    **dict.fromkeys(("--obs-dir", "--trace-spans", "--alarms"),
                    f"the observability slice ({_Q1}, item 24)"),
    # a no-op switch here: the guard is on unless --no-stall-guard
    "--stall-guard": f"a caller that needs it ({_Q1}, item 11); the "
                     f"guard is on by default",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m rlgpuschedule_tpu_torch.evaluate",
        description="JCT evaluation: the policy against the baseline "
                    "schedulers (PyTorch, on the GPU unless --device "
                    "says otherwise).")
    p.add_argument("--config", default="ppo-mlp-synth64")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--n-envs", type=int, default=None)
    add_config_flags(p)
    p.add_argument("--max-steps", type=int, default=None,
                   help="decision steps per window (default: the horizon)")
    p.add_argument("--eval-windows", type=int, default=None,
                   help="evaluate on this many windows of the config's "
                        "tiling instead of --n-envs")
    p.add_argument("--percentiles", action="store_true",
                   help="add p50/p90/p99 JCT columns per scheduler")
    p.add_argument("--baselines-only", action="store_true")
    p.add_argument("--no-random", action="store_true",
                   help="skip the random-policy row")
    p.add_argument("--backlog-gate", type=int, default=0,
                   help="evaluate the backlog-gated hybrid: while fewer "
                        "than N jobs are pending, play FIFO-with-backfill "
                        "instead of the policy (policy row only)")
    p.add_argument("--no-stall-guard", dest="stall_guard",
                   action="store_false",
                   help="turn off the stall guard, which masks a "
                        "preemptive policy's preempt actions past the "
                        "legitimate zero-dt activity bound, and replay "
                        "the raw argmax (it may then cycle place<->"
                        "preempt without end, short of completion)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p


def main(argv: "list[str] | None" = None) -> dict:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    refuse_unported(extra, parser, UNPORTED_FLAGS)
    if args.config not in CONFIGS:
        sys.exit(f"unknown config {args.config!r}")
    cfg = dataclasses.replace(CONFIGS[args.config], **config_overrides(args))
    check_source_jobs(args, cfg)
    if args.percentiles and args.baselines_only:
        sys.exit("--percentiles applies to the JCT table with a policy row "
                 "(no --baselines-only)")
    if args.eval_windows is not None and args.baselines_only:
        sys.exit("--eval-windows applies to the plain per-window JCT table "
                 "(no --baselines-only)")
    if args.backlog_gate < 0:
        sys.exit("--backlog-gate must be >= 0 (a negative gate would "
                 "silently run ungated)")
    if args.backlog_gate and args.baselines_only:
        sys.exit("--backlog-gate gates the policy row; --baselines-only "
                 "has none")
    if not args.stall_guard and (args.baselines_only
                                 or cfg.preempt_len == 0):
        sys.exit("--no-stall-guard applies to the policy row of a "
                 "preemptive config: the guard only ever masks preempt "
                 "actions, so it is a no-op elsewhere (refusing beats "
                 "silently changing nothing)")
    dev = resolve_device(args.device)
    repro = repro_tuple(cfg)

    try:
        if args.baselines_only:
            sim = build_env_params(cfg).sim
            windows = make_env_windows(cfg, validate_trace(
                sim, load_source_trace(cfg), clamp=True))
            report = baseline_jct_table(windows, cfg.n_nodes,
                                        cfg.gpus_per_node)
            print(format_report(report), file=sys.stderr)
            print(json.dumps({**report, "repro": repro}), flush=True)
            return report
        exp = Experiment.build(cfg, device=dev)
    except (NotImplementedError, ValueError) as e:
        sys.exit(str(e))
    print("note: no --ckpt-dir; evaluating untrained init weights",
          file=sys.stderr)
    windows = None
    if args.eval_windows is not None and args.eval_windows != cfg.n_envs:
        windows = make_env_windows(
            dataclasses.replace(cfg, n_envs=args.eval_windows), exp.source)
    report = jct_report(exp, windows=windows, max_steps=args.max_steps,
                        include_random=not args.no_random,
                        percentiles=PERCENTILES if args.percentiles
                        else None,
                        backlog_gate=args.backlog_gate,
                        stall_guard=args.stall_guard)
    print(format_report(report), file=sys.stderr)
    out = numeric_rows(report)
    if "percentiles" in report:
        out["percentiles"] = report["percentiles"]
    out.update(device=str(dev),
               device_name=(torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
               repro=repro)
    print(json.dumps(out), flush=True)
    return report


if __name__ == "__main__":
    main()
