"""Serving CLI of the port: ``python -m rlgpuschedule_tpu_torch.serve``.

``--fleet N`` replays the policy greedily against N seeded simulated
clusters of the config and prints the fleet report as JSON on stdout.
The weights come from ``--weights x.npz`` (a Flax parameter tree of the
JAX package saved flat, see :func:`..models.convert.load_npz`) or, by
default, from a seeded initialization. The device is ``cuda`` unless
``--device cpu`` is given.

``--bench``, ``--soak``, the router, the network front end and the
flight log of the JAX package's CLI wait for later slices, and so do
``--fleet-regime`` fault replays.

Example::

    python -m rlgpuschedule_tpu_torch.serve --config ppo-cnn-philly512 \\
        --fleet 512
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from ..configs import CONFIGS
from ..device import resolve_device
from ..experiment import build_env_params, build_policy
from ..models import load_npz
from .fleet import fleet_replay, fleet_windows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m rlgpuschedule_tpu_torch.serve",
        description="Greedy policy serving on the GPU: fleet replay.")
    p.add_argument("--config", default="ppo-mlp-synth64",
                   choices=sorted(CONFIGS))
    p.add_argument("--fleet", type=int, required=True, metavar="N",
                   help="replay the policy against N seeded clusters")
    p.add_argument("--max-steps", type=int, default=None,
                   help="cap decision steps per cluster (default: the "
                        "config's horizon)")
    p.add_argument("--seed", type=int, default=None,
                   help="trace and weight seed (default: the config's)")
    p.add_argument("--weights", default=None, metavar="NPZ",
                   help="Flax parameter tree saved flat as .npz")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--fleet-regime", default=None, metavar="REGIME",
                   help="per-cluster fault regime (not in this slice)")
    return p


def main(argv: "list[str] | None" = None) -> dict:
    args = build_parser().parse_args(argv)
    if args.fleet <= 0:
        sys.exit("--fleet must be a positive cluster count")
    if args.max_steps is not None and args.max_steps <= 0:
        sys.exit("--max-steps must be positive")
    if args.fleet_regime is not None:
        raise NotImplementedError(
            "--fleet-regime: fault-regime fleet replay waits for the "
            "faults slice of sim/core")
    cfg = CONFIGS[args.config]
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    dev = resolve_device(args.device)
    env_params = build_env_params(cfg)
    _, traces = fleet_windows(cfg, args.fleet, device=dev)
    policy = build_policy(cfg, env_params, device=dev)
    if args.weights:
        policy.load_state_dict(load_npz(args.weights))
        print(f"policy weights from {args.weights}", file=sys.stderr)
    else:
        print(f"note: no --weights; serving seeded init weights "
              f"(seed {cfg.seed})", file=sys.stderr)
    fl = fleet_replay(policy, env_params, traces, max_steps=args.max_steps,
                      device=dev)
    report = {"config": cfg.name, "seed": cfg.seed, "weights": args.weights,
              "fleet": fl}
    if dev.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(dev)
    print(f"fleet: {fl['n_clusters']} clusters on {dev}, mean JCT "
          f"{fl['mean_jct']:.1f} s, completion {fl['completion']:.1%}, "
          f"{fl['decisions']} decisions in {fl['wall_s']:.2f} s "
          f"({fl['decisions_per_s']:.0f}/s)", file=sys.stderr)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
