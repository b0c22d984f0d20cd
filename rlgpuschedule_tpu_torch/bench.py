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

``--async [--staleness-bound N] [--correction vtrace] [--repeats R]``
prints the root bench's ``bench_async`` line instead
(:func:`bench_async`): the async actor-learner engine against the
per-iteration sync loop, the median of ``R`` calls (default 5, the root
bench's count) of 5 iterations an arm (3 on the CPU), with the card's
name and power limit.

Examples::

    python -m rlgpuschedule_tpu_torch.bench
    python -m rlgpuschedule_tpu_torch.bench --n-epochs 4 --n-minibatches 4
    python -m rlgpuschedule_tpu_torch.bench --device cpu
    python -m rlgpuschedule_tpu_torch.bench --async --staleness-bound 1
    python -m rlgpuschedule_tpu_torch.bench --async --repeats 3
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
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
# the root bench's flags this one does not take, and what they wait for
UNPORTED_FLAGS: dict[str, str] = {
    "--mesh": "the data-parallel slice (ROADMAP.md queue 1, item 21)",
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
    p.add_argument("--async", dest="async_run", action="store_true",
                   help="benchmark the async actor-learner engine against "
                        "the per-iteration sync loop (same workload, same "
                        "card) instead of the fused bench")
    p.add_argument("--staleness-bound", type=int, default=1,
                   help="with --async: the engine's staleness bound")
    p.add_argument("--repeats", type=int, default=None,
                   help="with --async: timed calls an arm, the median "
                        "reported (default 5)")
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


def time_async_against_sync(sync_exp, runner, iters: int, repeats: int
                            ) -> tuple[float, float, dict]:
    """The per-iteration sync loop against the async engine on one
    workload (``bench --async`` and ``profile_breakdown --async``): one
    warm-up iteration an arm (the port builds no program), then the
    median wall of ``repeats`` calls of ``iters`` iterations of
    ``sync_exp.run``, then of ``runner.run``; each call synchronizes the
    card at both ends. Returns both medians (seconds a call) and the
    engine's last timed result."""
    def median_wall(run) -> float:
        walls = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls)

    last: dict = {}
    sync_exp.run(iterations=1)
    t_sync = median_wall(lambda: sync_exp.run(iterations=iters))
    runner.run(iterations=1)
    t_async = median_wall(
        lambda: last.update(runner.run(iterations=iters)))
    return t_sync, t_async, last


def bench_async(cfg, args, dev: torch.device, iters: int) -> dict:
    """``--async``: the async actor-learner engine against the sync
    per-iteration loop, same workload, same card: the root bench's
    ``bench_async`` line, each arm the median of ``args.repeats`` calls
    of ``iters`` iterations (:func:`time_async_against_sync`). The sync
    comparator is ``Experiment.run`` (one iteration at a time), not the
    fused bench: the engine overlaps per-iteration work, so that is the
    like-for-like baseline. Beside the measured ratio,
    ``projected_overlap_speedup = (R+U)/max(R,U)`` from the engine's own
    phase accounting is the overlap ceiling, and
    ``async_overlap_measured`` the span timeline's occupancy in one more,
    traced and untimed, call. A ratio inside one process is fair to both
    arms; the absolute rates are not the fused bench's. The root bench
    calibrates its call to about 1.5 s (0.5 s on the CPU); the port's
    ``iters`` already outlasts that at the card's geometry."""
    import os
    import tempfile

    from .async_engine import AsyncRunner
    from .obs import RunTelemetry, read_events
    from .obs.trace import async_overlap_summary

    cuda = dev.type == "cuda"
    if args.correction != "none":
        # the deep-staleness pipeline; the sync comparator stays
        # uncorrected (on-policy, its ratios would be identically 1)
        cfg = dataclasses.replace(
            cfg, ppo=dataclasses.replace(cfg.ppo,
                                         correction=args.correction))
    sync_cfg = dataclasses.replace(
        cfg, ppo=dataclasses.replace(cfg.ppo, correction="none"))
    exp_s = Experiment.build(sync_cfg, device=dev)
    runner = AsyncRunner(Experiment.build(cfg, device=dev),
                         staleness_bound=args.staleness_bound,
                         queue_capacity=max(2, args.staleness_bound))
    t_sync, t_async, _ = time_async_against_sync(exp_s, runner, iters,
                                                 args.repeats)
    sync_v = iters * exp_s.steps_per_iteration / t_sync
    async_v = iters * exp_s.steps_per_iteration / t_async
    # the measured occupancy: one more call, traced and untimed (span
    # emission is file IO per iteration); log_every reads the ratio
    # stats the correction reports
    with tempfile.TemporaryDirectory() as td:
        with RunTelemetry(td, trace=True, device=dev) as tel:
            runner.run(iterations=iters, log_every=10,
                       logger=lambda i, m: None, telemetry=tel)
            events_path = tel.bus.path
        overlap = async_overlap_summary(read_events(events_path))
    info = runner.async_info()
    r_busy, u_busy = info["actor_busy_s"], info["learner_busy_s"]
    ceiling = ((r_busy + u_busy) / max(r_busy, u_busy)
               if max(r_busy, u_busy) > 0 else None)
    name, limit = card_info() if cuda else ("cpu", None)
    out = {
        "metric": f"async_actor_learner_speedup[{dev.type}]",
        "method": "sync-iter-loop-vs-async-engine",
        "staleness_bound": args.staleness_bound,
        "correction": args.correction,
        "groups": runner.groups.describe(),
        "cores": os.cpu_count(),
        "iters_per_repeat": iters,
        "repeats": args.repeats,
        "sync_env_steps_per_sec_per_chip": round(sync_v, 1),
        "async_env_steps_per_sec_per_chip": round(async_v, 1),
        "speedup": round(async_v / sync_v, 3),
        "actor_busy_s": round(r_busy, 3),
        "learner_busy_s": round(u_busy, 3),
        "projected_overlap_speedup":
            round(ceiling, 3) if ceiling else None,
        "async_overlap_measured": (overlap["async_overlap_measured"]
                                   if overlap else None),
        "overlap_window": overlap,
        "overlap_s": round(info["overlap_s"], 3),
        "staleness_max": info["staleness_max"],
        "importance_ratio_mean": info["importance_ratio_mean"],
        "importance_ratio_max": info["importance_ratio_max"],
        "note": ("projected_overlap_speedup is the phase-time ceiling "
                 "(R+U)/max(R,U); async_overlap_measured is the span-"
                 "timeline occupancy of one traced repeat (1 - idle/"
                 "window). Both loops are Python threads under one GIL, "
                 "each on its own CUDA stream; a ratio inside one process "
                 "is fair to both arms, the absolute rates are not the "
                 "fused bench's"),
        "device_name": name,
        "power_limit": limit,
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv: "list[str] | None" = None) -> dict:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    refuse_unported(extra, parser, UNPORTED_FLAGS)
    if args.repeats is not None and not args.async_run:
        raise SystemExit("--repeats applies with --async (the fused "
                         "bench's repeats follow its stop rule)")
    if args.repeats is None:
        args.repeats = 5
    if args.repeats < 1:
        raise SystemExit("--repeats must be >= 1")
    try:
        validate_mode_combination({"async": args.async_run,
                                   "vtrace": args.correction == "vtrace",
                                   "sync": not args.async_run})
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
    cfg = dataclasses.replace(base, n_envs=n_envs, ppo=ppo)
    if args.async_run:
        return bench_async(cfg, args, dev, iters)
    exp = Experiment.build(cfg, device=dev)

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
