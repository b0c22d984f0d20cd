"""Training CLI (L6) of the port:
``python -m rlgpuschedule_tpu_torch.train --config <name>``.

Counterpart of the JAX package's ``train.py`` for single-run PPO. It
takes the subset of that CLI's flags this port implements; every other
flag of the JAX CLI is refused with a message that names the slice it
waits for. One JSON line per logged iteration, then a summary line with
env-steps/s and the device it ran on.

Examples::

    python -m rlgpuschedule_tpu_torch.train --config ppo-cnn-philly512 \\
        --iterations 3 --log-every 1
    python -m rlgpuschedule_tpu_torch.train --config ppo-mlp-synth64 \\
        --n-envs 2 --n-steps 16 --iterations 2 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from .configs import CONFIGS, ExperimentConfig
from .experiment import Experiment

_Q1 = "ROADMAP.md queue 1"
# the JAX CLI's flags that this port does not take, and what they wait for
UNPORTED_FLAGS: dict[str, str] = {
    **dict.fromkeys(
        ("--n-nodes", "--gpus-per-node", "--window-jobs", "--queue-len",
         "--horizon", "--obs-kind"),
        f"the config-override flags of the train CLI ({_Q1}, item 10)"),
    **dict.fromkeys(
        ("--trace", "--trace-path", "--trace-load", "--source-jobs"),
        f"the CSV and custom trace slice ({_Q1}, item 13)"),
    **dict.fromkeys(("--resample-every", "--drain-frac"),
                    f"window streaming ({_Q1}, item 13)"),
    **dict.fromkeys(("--faults", "--domains"),
                    f"the chaos and domain slice ({_Q1}, item 17)"),
    **dict.fromkeys(
        ("--bf16-update", "--correction", "--reward-norm",
         "--bf16-advantages"),
        f"the off-policy and precision slice ({_Q1}, item 18)"),
    **dict.fromkeys(("--pbt", "--n-pop", "--pbt-ready"),
                    f"the hierarchical/PBT slice ({_Q1}, item 19)"),
    **dict.fromkeys(
        ("--async", "--actor-devices", "--learner-devices",
         "--staleness-bound", "--queue-capacity"),
        f"the async actor-learner slice ({_Q1}, item 20)"),
    **dict.fromkeys(("--mesh", "--max-rollbacks", "--fault"),
                    f"the data-parallel and resilience slice ({_Q1}, "
                    f"item 21)"),
    **dict.fromkeys(
        ("--eval-every", "--eval-windows", "--eval-seed", "--eval-probe",
         "--keep-best", "--report"),
        f"the evaluation slice ({_Q1}, item 11)"),
    **dict.fromkeys(("--ckpt-dir", "--ckpt-every", "--ckpt-keep",
                     "--resume"),
                    f"the checkpoint slice ({_Q1}, item 12)"),
    **dict.fromkeys(("--continual", "--continual-trust",
                     "--continual-rho-max"),
                    f"the data-flywheel slice ({_Q1}, item 23)"),
    "--fused-chunk": f"run_fused ({_Q1}, item 10)",
    **dict.fromkeys(
        ("--log-csv", "--tb-dir", "--profile-dir", "--obs-dir", "--alarms",
         "--alarm-slow-iter", "--trace-spans", "--debug-nans"),
        f"the observability slice ({_Q1}, item 24)"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m rlgpuschedule_tpu_torch.train",
        description="Train an RL GPU-cluster scheduling policy with PPO "
                    "(PyTorch, on the GPU unless --device says otherwise).")
    p.add_argument("--config", default="ppo-mlp-synth64",
                   help="named preset (see --list-configs)")
    p.add_argument("--list-configs", action="store_true")
    # config overrides (None = keep the preset's value)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--n-envs", type=int, default=None)
    p.add_argument("--n-steps", type=int, default=None,
                   help="rollout length T per iteration")
    p.add_argument("--n-epochs", type=int, default=None,
                   help="update epochs per iteration")
    p.add_argument("--n-minibatches", type=int, default=None,
                   help="minibatches per update epoch")
    p.add_argument("--minibatch-size", type=int, default=None,
                   help="explicit minibatch size (overrides "
                        "--n-minibatches; must tile n_steps * n_envs)")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--ent-coef", type=float, default=None)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p


def apply_overrides(cfg: ExperimentConfig,
                    args: argparse.Namespace) -> ExperimentConfig:
    fields = {"iterations": args.iterations, "seed": args.seed,
              "n_envs": args.n_envs}
    cfg = dataclasses.replace(
        cfg, **{k: v for k, v in fields.items() if v is not None})
    ppo = {"lr": args.lr, "ent_coef": args.ent_coef,
           "n_steps": args.n_steps, "n_epochs": args.n_epochs,
           "n_minibatches": args.n_minibatches,
           "minibatch_size": args.minibatch_size}
    over = {k: v for k, v in ppo.items() if v is not None}
    if over:
        cfg = dataclasses.replace(cfg,
                                  ppo=dataclasses.replace(cfg.ppo, **over))
    return cfg


def _refuse_unported(extra: list[str], parser: argparse.ArgumentParser):
    for tok in extra:
        flag = tok.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            sys.exit(f"{flag} is not in the PyTorch port yet: it waits for "
                     f"{UNPORTED_FLAGS[flag]}")
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")


def main(argv: "list[str] | None" = None) -> dict:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    _refuse_unported(extra, parser)
    if args.list_configs:
        for name, c in CONFIGS.items():
            print(f"{name:20s} algo={c.algo} obs={c.obs_kind} "
                  f"cluster={c.n_nodes}x{c.gpus_per_node} trace={c.trace}"
                  f"{' pods=' + str(c.n_pods) if c.n_pods > 1 else ''}")
        return {}
    if args.config not in CONFIGS:
        sys.exit(f"unknown config {args.config!r}; try --list-configs")
    cfg = apply_overrides(CONFIGS[args.config], args)
    try:
        exp = Experiment.build(cfg, device=args.device)
    except NotImplementedError as e:
        sys.exit(str(e))

    def logger(i: int, m: dict) -> None:
        print(json.dumps({"iteration": i, **m}), flush=True)

    out = exp.run(log_every=args.log_every, logger=logger)
    dev = exp.device
    summary = {k: v for k, v in out.items() if k != "history"}
    summary.update(
        config=cfg.name, n_envs=cfg.n_envs, n_steps=cfg.ppo.n_steps,
        device=str(dev),
        device_name=(torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else "cpu"))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
