"""Training-throughput benchmark of the port:
``python -m rlgpuschedule_tpu_torch.bench``.

Counterpart of the repo root's ``bench.py`` (the JAX package's): PPO
env-steps/s per card on config 1 (``ppo-mlp-synth64``) at 512 envs x
128 steps, 5 iterations per timing, on the card (32 x 64 x 3 with
``--device cpu``, which only proves the path runs). Each timing is
:meth:`..experiment.Experiment.run_fused` between two
``torch.cuda.synchronize`` calls. The repeat length is calibrated to
about 1.5 s (0.4 s on the CPU) from the fastest of 3 timings, then
repeats are sampled until at least 7 have been taken and the spread of
the middle 5 over the median is under 0.15, or 15 have been taken.

Prints one JSON line: the metric, the method, the update geometry, the
median (``value``) with its repeats, ``min``/``max``, the central and
raw spreads and ``noisy``, the card's name and power limit
(``nvidia-smi``) and ``vs_baseline: null``: no figure of the JAX
package or of a TPU is a baseline for the port.

Examples::

    python -m rlgpuschedule_tpu_torch.bench
    python -m rlgpuschedule_tpu_torch.bench --n-epochs 4 --n-minibatches 4
    python -m rlgpuschedule_tpu_torch.bench --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import torch

from .algos.update import resolve_geometry
from .cli import refuse_unported
from .configs import (CONFIGS, ModeCombinationError,
                      validate_mode_combination)
from .device import resolve_device
from .experiment import Experiment

METHOD = "run-fused"
_Q1 = "ROADMAP.md queue 1"
# the root bench's flags this one does not take, and what they wait for
UNPORTED_FLAGS: dict[str, str] = {
    "--mesh": f"the data-parallel and resilience slice ({_Q1}, item 21)",
    **dict.fromkeys(("--async", "--staleness-bound"),
                    f"the async actor-learner slice ({_Q1}, item 20)"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m rlgpuschedule_tpu_torch.bench",
        description="PPO env-steps/s per card on config 1 (PyTorch, on "
                    "the GPU unless --device says otherwise).")
    p.add_argument("--n-epochs", type=int, default=2)
    p.add_argument("--n-minibatches", type=int, default=8)
    p.add_argument("--minibatch-size", type=int, default=None)
    p.add_argument("--sweep", default=None, metavar="SWEEP_JSON",
                   help="take the update geometry from this ranked "
                        "minibatch-geometry sweep artifact (its 'best' "
                        "entry; explicit geometry flags are refused "
                        "alongside it)")
    p.add_argument("--correction", default="none",
                   choices=["none", "vtrace"],
                   help="advantage correction; 'vtrace' needs the async "
                        "engine and is refused on the synchronous loop")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p


def geometry_from_sweep(path: str) -> tuple[int, int]:
    """(n_epochs, n_minibatches) of a sweep artifact's best entry; any
    other file is refused (benching the default geometry would mislabel
    the number)."""
    with open(path) as f:
        art = json.load(f)
    if art.get("sweep") != "minibatch-geometry" or "best" not in art:
        raise SystemExit(
            f"{path} is not a profile_breakdown --sweep-minibatch "
            f"artifact (missing sweep/best fields)")
    best = art["best"]
    return int(best["n_epochs"]), int(best["n_minibatches"])


def central_spread(s: list[float], k: int = 5) -> float:
    """Spread of the middle ``k`` of the sorted samples over their
    median: the stop rule and the reported noise figure (a min-max over
    all samples never shrinks, so one early hiccup would keep a clean
    run from converging)."""
    lo = max((len(s) - k) // 2, 0)
    mid = s[lo:lo + k]
    return (mid[-1] - mid[0]) / s[len(s) // 2]


def card_info() -> tuple[str | None, str | None]:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


def main(argv: "list[str] | None" = None) -> dict:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    refuse_unported(extra, parser, UNPORTED_FLAGS)
    try:
        validate_mode_combination({"vtrace": args.correction == "vtrace",
                                   "sync": True})
    except ModeCombinationError as e:
        raise SystemExit(str(e))
    if args.sweep is not None:
        if args.n_epochs != 2 or args.n_minibatches != 8 \
                or args.minibatch_size is not None:
            raise SystemExit("--sweep supplies the geometry; drop the "
                             "explicit --n-epochs/--n-minibatches/"
                             "--minibatch-size flags")
        args.n_epochs, args.n_minibatches = geometry_from_sweep(args.sweep)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    n_envs, n_steps, iters = (512, 128, 5) if cuda else (32, 64, 3)
    base = CONFIGS["ppo-mlp-synth64"]
    ppo = dataclasses.replace(base.ppo, n_steps=n_steps,
                              n_epochs=args.n_epochs,
                              n_minibatches=args.n_minibatches,
                              minibatch_size=args.minibatch_size)
    _, n_mb, mb_size = resolve_geometry(ppo.n_epochs, ppo.n_minibatches,
                                        ppo.minibatch_size, n_steps * n_envs)
    exp = Experiment.build(dataclasses.replace(base, n_envs=n_envs,
                                               ppo=ppo), device=dev)

    def sync() -> float:
        if cuda:
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def timed(k: int) -> float:
        t0 = sync()
        exp.run_fused(k)
        return sync() - t0

    timed(iters)                                 # warm-up
    target_s = 1.5 if cuda else 0.4
    # the fastest of 3: a hiccup only ever adds time
    cal = max(min(timed(iters) for _ in range(3)), 1e-6)
    iters_rep = max(iters, min(20_000, int(iters * target_s / cal)))
    min_repeats, max_repeats = 7, 15
    samples: list[float] = []
    while True:
        samples.append(iters_rep * exp.steps_per_iteration
                       / timed(iters_rep))
        s = sorted(samples)
        value = s[len(s) // 2]
        spread = central_spread(s)
        if (len(samples) >= min_repeats and spread < 0.15) \
                or len(samples) >= max_repeats:
            break
    name, limit = card_info() if cuda else ("cpu", None)
    out = {
        "metric": f"ppo_env_steps_per_sec_per_chip[{dev.type}]",
        "method": METHOD,
        "config": base.name, "n_envs": n_envs, "n_steps": n_steps,
        "geometry": {"n_epochs": ppo.n_epochs, "n_minibatches": n_mb,
                     "minibatch_size": mb_size},
        "value": value,
        "unit": "env-steps/s/chip",
        "vs_baseline": None,
        "repeats": len(samples),
        "iters_per_repeat": iters_rep,
        "min": s[0],
        "max": s[-1],
        "spread": spread,
        "spread_raw": (s[-1] - s[0]) / value,
        "noisy": spread > 0.2,
        "device_name": name,
        "power_limit": limit,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
