"""Where the time of a training iteration goes (L6 aux) on the port:
``python -m rlgpuschedule_tpu_torch.profile_breakdown``.

Counterpart of the JAX package's ``profile_breakdown.py``. It splits
one PPO iteration of config 1 (``ppo-mlp-synth64``; 512 envs x 128
steps on the card, 32 x 64 on the CPU) into its stages:

- **rollout**: the policy+env decision loop (``algos.rollout``),
- **gae**: the bare GAE scan and the advantage normalization (the
  reference row),
- **advantage**: the production advantage pipeline
  (``algos.ppo.compute_advantages``: optional reward normalization,
  GAE or V-trace, normalization, optional bf16 storage),
- **update**: the epoch x minibatch clipped-surrogate updates, on a copy
  of the policy and a fresh optimizer threaded call to call,
- **fused_loop**: the production train step, called back to back with
  the card synchronized only at the ends,
- **fused_step_blocked**: the same step synchronized after every call,
- **pipeline_overlap**: blocked minus back-to-back, the host work
  (Python dispatch, launches) that running ahead of the card hides.

Each stage is warmed, then timed as the median of ``--repeats`` windows
of ``--iters-per-repeat`` calls, the card synchronized at the edges of
each window only. On the card every window also records a
``torch.cuda.Event`` pair (``device_span_ms_per_iteration``): the
window's span on the card, idle gaps included, so with the edges
synchronized it tracks the wall whatever bounds the stage. What the card
really spent is ``device_busy_ms_per_iteration``: one more call per
stage under the torch profiler, the union of its kernel and copy
intervals (``utils.profiling.device_busy_ms``); ``device_busy_share``
is that over the stage's wall, and one minus it is the card's idle
share. All three are null on the CPU.

The artifact (one JSON line) has the JAX package's keys: per-stage
seconds per iteration, the stage shares, env-steps/s, the policy's
parameter count and a model-FLOPs/s estimate (2 x params per forward
MAC, 3x for forward and backward, over every policy evaluation), plus
the device milliseconds, the sum of the parts over the fused loop and
the card's name (``device_kind``) and power limit. ``mfu_total`` (the
fused step) and ``mfu_update`` (the update alone) price the estimate
against :data:`BF16_PEAK`, the card's published dense bf16 tensor-core
peak, keyed on ``torch.cuda.get_device_name()``; they are null for a
card the table does not hold and on the CPU.

``--sweep-minibatch`` times the update stage alone over every
power-of-two minibatch count that tiles the batch (and the configured
one), at 1 and at ``--n-epochs`` epochs, and prints a ranked artifact
(fastest first, ``best`` repeated at the top level) that
``python -m rlgpuschedule_tpu_torch.bench --sweep FILE`` reads.
``--trace-dir`` adds a torch profiler trace of one fused step
(``utils.profiling.trace``; JAX's traces the timed window of
``--iters-per-repeat`` steps, but one config-1 step at 512 x 128 is
already about 100 MB of trace). ``--async`` prints JAX's actor-learner
phase table instead (:func:`_profile_async`: the sync loop against the
async engine at ``--staleness-bound``, with the engine's phase seconds
and counters; ``--async-out`` also writes it to a file).

Examples::

    python -m rlgpuschedule_tpu_torch.profile_breakdown --repeats 3
    python -m rlgpuschedule_tpu_torch.profile_breakdown \\
        --sweep-minibatch --sweep-out sweep.json
    python -m rlgpuschedule_tpu_torch.profile_breakdown --device cpu \\
        --n-envs 2 --n-steps 8 --repeats 1
    python -m rlgpuschedule_tpu_torch.profile_breakdown --async \\
        --staleness-bound 1 --async-out async.json
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import statistics
import time

import torch

from .algos.ppo import (PPOConfig, compute_advantages, make_train_state,
                        normalize_advantages, run_ppo_epochs)
from .algos.rollout import rollout
from .algos.update import resolve_geometry
from .bench import card_info, time_async_against_sync
from .configs import CONFIGS
from .device import resolve_device
from .experiment import Experiment
from .ops.gae import compute_gae
from .utils import profiling

# the published dense bf16 tensor-core peak (FLOP/s) of each card, keyed
# on torch.cuda.get_device_name(): the H100 SXM5's, from NVIDIA's
# datasheet (989.4 TFLOP/s without sparsity)
BF16_PEAK = {"NVIDIA H100 80GB HBM3": 989.4e12}


class _Clock:
    """Median-of-N timing of a window of ``n`` calls: the card is
    synchronized at the window's edges only, and on the card an event
    pair gives the window's span on the card."""

    def __init__(self, device: torch.device, repeats: int):
        self.cuda = device.type == "cuda"
        self.device = device
        self.repeats = repeats

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def __call__(self, fn, n: int) -> tuple[float, "float | None"]:
        """(median wall seconds, median device span ms) per call of
        ``fn`` over ``repeats`` windows of ``n`` calls."""
        walls, device_ms = [], []
        for _ in range(self.repeats):
            self.sync()
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            if self.cuda:
                end.record()
            self.sync()
            walls.append(time.perf_counter() - t0)
            if self.cuda:
                device_ms.append(start.elapsed_time(end))
        return (statistics.median(walls) / n,
                statistics.median(device_ms) / n if self.cuda else None)

    def busy(self, fn) -> "float | None":
        """The card's busy ms in one profiled call of ``fn`` (None on
        the CPU)."""
        return (profiling.device_busy_ms(fn, 1, self.device) if self.cuda
                else None)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m rlgpuschedule_tpu_torch.profile_breakdown",
        description="Stage breakdown of a PPO iteration of config 1 "
                    "(PyTorch, on the GPU unless --device says "
                    "otherwise).")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--iters-per-repeat", type=int, default=3)
    ap.add_argument("--n-envs", type=int, default=None,
                    help="default: 512 on the card, 32 on the CPU")
    ap.add_argument("--n-steps", type=int, default=None,
                    help="default: 128 on the card, 64 on the CPU")
    ap.add_argument("--n-epochs", type=int, default=2,
                    help="update geometry: PPO epochs over the batch")
    ap.add_argument("--n-minibatches", type=int, default=8,
                    help="update geometry: minibatch count per epoch "
                         "(profile the swept-best with e.g. 1)")
    ap.add_argument("--minibatch-size", type=int, default=None,
                    help="update geometry: explicit minibatch size; "
                         "overrides --n-minibatches (algos.update "
                         "resolve_geometry contract)")
    ap.add_argument("--bf16-update", action="store_true",
                    help="profile the bf16-compute / fp32-optimizer "
                         "update path")
    ap.add_argument("--correction", choices=["none", "vtrace"],
                    default="none",
                    help="advantage pipeline: V-trace importance-corrected "
                         "targets instead of plain GAE; the advantage row "
                         "then prices the batched target-policy recompute "
                         "the off-policy path adds")
    ap.add_argument("--reward-norm", action="store_true",
                    help="advantage pipeline: streaming Welford reward "
                         "standardization before the target scan")
    ap.add_argument("--bf16-advantages", action="store_true",
                    help="advantage pipeline: store advantages/returns in "
                         "bf16 (the update still computes fp32)")
    ap.add_argument("--sweep-minibatch", action="store_true",
                    help="time the update stage over a grid of minibatch "
                         "geometries and emit a ranked JSON artifact "
                         "(steps/s + mfu_update) instead of the stage "
                         "breakdown")
    ap.add_argument("--sweep-out", default=None,
                    help="with --sweep-minibatch: also write the ranked "
                         "artifact to this path (bench --sweep reads it)")
    ap.add_argument("--trace-dir", default=None,
                    help="also capture a torch profiler trace of one "
                         "fused step here")
    ap.add_argument("--async", dest="async_run", action="store_true",
                    help="profile the overlapped actor-learner engine "
                         "against the sync loop (phase table) instead of "
                         "the stage breakdown")
    ap.add_argument("--staleness-bound", type=int, default=1,
                    help="with --async: the engine's staleness bound")
    ap.add_argument("--async-out", default=None,
                    help="with --async: also write the phase-table "
                         "artifact to this path")
    return ap


def _sweep_minibatch(ppo: PPOConfig, time_update, B: int, n_params: int,
                     peak: "float | None", t_adv: float,
                     context: dict) -> dict:
    """Time the update stage over the geometry grid (epochs in ``{1,
    configured}`` x every power-of-two minibatch count up to 128 that
    tiles the batch, plus the configured one) and rank the geometries
    fastest first; JAX's artifact."""
    _, default_mb, _ = resolve_geometry(ppo.n_epochs, ppo.n_minibatches,
                                        ppo.minibatch_size, B)
    mbs = sorted({m for m in (2 ** p for p in range(0, 8))
                  if m <= B and B % m == 0} | {default_mb})
    results = []
    for e in sorted({1, ppo.n_epochs}):
        upd_flops = 2 * n_params * 3 * e * B     # fwd+bwd per sample
        for m in mbs:
            geom = dataclasses.replace(ppo, n_epochs=e, n_minibatches=m,
                                       minibatch_size=None)
            t, dev_ms = time_update(geom)
            results.append({
                "n_epochs": e, "n_minibatches": m,
                "minibatch_size": B // m,
                "update_s_per_iteration": round(t, 5),
                "update_device_ms_per_iteration": (
                    round(dev_ms, 3) if dev_ms is not None else None),
                "update_env_steps_per_sec": round(B / t, 1),
                "model_flops_per_sec": round(upd_flops / t, 1),
                "mfu_update": (round(upd_flops / t / peak, 6)
                               if peak is not None else None),
            })
    default = next(r for r in results
                   if r["n_epochs"] == ppo.n_epochs
                   and r["n_minibatches"] == default_mb)
    for r in results:
        r["speedup_vs_default"] = round(
            default["update_s_per_iteration"]
            / r["update_s_per_iteration"], 3)
    results.sort(key=lambda r: r["update_s_per_iteration"])
    return {
        "sweep": "minibatch-geometry",
        **context,
        "batch_per_iteration": B,
        "bf16_update": ppo.bf16_update,
        "advantage_pipeline": {"correction": ppo.correction,
                               "reward_norm": ppo.reward_norm,
                               "bf16_advantages": ppo.bf16_advantages},
        # the advantage phase runs once per iteration, before the
        # geometry grid: one figure for every row
        "advantage_s_per_iteration": round(t_adv, 5),
        "policy_params": int(n_params),
        "assumed_bf16_peak_flops": peak,
        "default_geometry": {"n_epochs": ppo.n_epochs,
                             "n_minibatches": default_mb},
        "results": results,            # ranked fastest first
        "best": results[0],
    }


def _profile_async(args, cfg, context: dict) -> dict:
    """The sync-against-async phase table on one workload (JAX's
    ``_profile_async``): the per-iteration sync loop and the async
    engine, each the median of ``--repeats`` calls of
    ``--iters-per-repeat`` iterations
    (:func:`..bench.time_async_against_sync`, shared with ``bench
    --async``), then the engine's own accounting:
    per-phase host seconds of the last timed call (``actor``,
    ``learner``, ``queue_wait``, ``sync``) and the cumulative
    overlap/staleness counters of ``async_info()``.
    ``projected_overlap_speedup`` is the phase-time ceiling ``(actor +
    learner) / max(actor, learner)``; the measured ``speedup`` is what
    this host and card deliver (the two loops share one GIL)."""
    import os

    from .async_engine import AsyncRunner

    dev = context["device"]
    n = args.iters_per_repeat
    runner = AsyncRunner(Experiment.build(cfg, device=dev),
                         staleness_bound=args.staleness_bound)
    t_sync, t_async, last = time_async_against_sync(
        Experiment.build(cfg, device=dev), runner, n, args.repeats)
    t_sync, t_async = t_sync / n, t_async / n
    phases = last["phase_seconds"]                 # last timed run only
    info = last["async"]                           # cumulative counters
    busy_a = phases.get("actor", 0.0)
    busy_l = phases.get("learner", 0.0)
    parts = busy_a + busy_l
    return {
        "profile": "async-phase-table",
        "platform": context["platform"],
        "device_kind": context["device_kind"],
        "power_limit": context["power_limit"],
        "cores": os.cpu_count(),
        "n_envs": cfg.n_envs, "n_steps": cfg.ppo.n_steps,
        "iters_per_repeat": n, "repeats": args.repeats,
        "staleness_bound": args.staleness_bound,
        "groups": runner.groups.describe(),
        "seconds_per_iteration": {
            "sync_loop": round(t_sync, 5),
            "async_loop": round(t_async, 5)},
        "speedup": round(t_sync / t_async, 3),
        "async_phase_seconds_per_iteration": {
            k: round(v / n, 5) for k, v in sorted(phases.items())},
        "async_phase_share_of_busy": {
            "actor": round(busy_a / parts, 3) if parts else None,
            "learner": round(busy_l / parts, 3) if parts else None},
        "projected_overlap_speedup": round(
            parts / max(busy_a, busy_l), 3) if parts else None,
        "queue_wait_s_cumulative": {
            "actor_idle": info["actor_idle_s"],
            "learner_idle": info["learner_idle_s"]},
        "staleness": {"max": info["staleness_max"],
                      "mean": info["staleness_mean"]},
        "overlap_s_cumulative": info["overlap_s"],
        "note": "phase seconds are the last timed run's SectionTimer; "
                "queue_wait/overlap/staleness counters are cumulative "
                "over warmup + all repeats",
    }


def main(argv: "list[str] | None" = None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.sweep_out and not args.sweep_minibatch:
        ap.error("--sweep-out only applies with --sweep-minibatch")
    if args.async_out and not args.async_run:
        ap.error("--async-out only applies with --async")
    if args.async_run and (args.sweep_minibatch or args.trace_dir):
        ap.error("--async is exclusive with --sweep-minibatch/--trace-dir")
    if args.repeats < 1 or args.iters_per_repeat < 1:
        ap.error("--repeats and --iters-per-repeat must be >= 1")
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    n_envs = args.n_envs or (512 if cuda else 32)
    n_steps = args.n_steps or (128 if cuda else 64)
    ppo = PPOConfig(n_steps=n_steps, n_epochs=args.n_epochs,
                    n_minibatches=args.n_minibatches,
                    minibatch_size=args.minibatch_size,
                    bf16_update=args.bf16_update,
                    correction=args.correction,
                    reward_norm=args.reward_norm,
                    bf16_advantages=args.bf16_advantages)
    cfg = dataclasses.replace(CONFIGS["ppo-mlp-synth64"], n_envs=n_envs,
                              ppo=ppo)
    B = n_steps * n_envs
    _, n_mb, mb = resolve_geometry(ppo.n_epochs, ppo.n_minibatches,
                                   ppo.minibatch_size, B)
    name, limit = card_info() if cuda else ("cpu", None)
    context = {"platform": "gpu" if cuda else "cpu",
               "device_kind": name if cuda else None,
               "power_limit": limit, "n_envs": n_envs, "n_steps": n_steps}
    if args.async_run:
        out = _profile_async(args, cfg, {**context, "device": dev})
        print(json.dumps(out), flush=True)
        if args.async_out:
            with open(args.async_out, "w") as f:
                json.dump(out, f, indent=1)
        return out
    exp = Experiment.build(cfg, device=dev)
    env_params, traces, faults = exp.env_params, exp.traces, exp.faults
    n_params = sum(p.numel() for p in exp.net.parameters())
    peak = BF16_PEAK.get(name) if cuda else None
    clock = _Clock(dev, args.repeats)
    n = args.iters_per_repeat

    # one rollout feeds the gae, advantage and update stages
    carry = exp.carry
    _, tr, last_value = rollout(exp.net, env_params, traces, carry,
                                n_steps, faults=faults)

    def advantage():
        _st, a, r, _rho = compute_advantages(ppo, exp.train_state, tr,
                                             last_value)
        return a, r

    adv, ret = advantage()
    t_adv, d_adv = clock(advantage, n)

    def update_fn(geom: PPOConfig):
        """The update at ``geom`` on a copy of the policy with a fresh
        optimizer, threaded call to call as the production loop threads
        its state; called once (warm) before it is returned."""
        state = make_train_state(copy.deepcopy(exp.net), geom)
        gen = torch.Generator(dev).manual_seed(0)

        def update():
            run_ppo_epochs(geom, state, tr, adv, ret, generator=gen)

        update()
        return update

    def time_update(geom: PPOConfig) -> tuple[float, "float | None"]:
        return clock(update_fn(geom), n)

    if args.sweep_minibatch:
        out = _sweep_minibatch(ppo, time_update, B, n_params, peak, t_adv,
                               context)
        print(json.dumps(out), flush=True)
        if args.sweep_out:
            with open(args.sweep_out, "w") as f:
                json.dump(out, f, indent=1)
        return out

    update_step = update_fn(ppo)
    t_upd, d_upd = clock(update_step, n)

    def rollout_only():
        rollout(exp.net, env_params, traces, carry, n_steps, faults=faults)

    def gae_only():
        a, _r = compute_gae(tr.reward, tr.value, tr.done, last_value,
                            ppo.gamma, ppo.gae_lambda)
        normalize_advantages(a)

    def fused_step():
        exp.train_state, exp.carry, _m = exp.train_step(
            exp.train_state, exp.carry, traces, exp.generator, faults)

    def fused_blocked():
        fused_step()
        clock.sync()

    for fn in (rollout_only, gae_only, fused_step):   # warm
        fn()
    t_roll, d_roll = clock(rollout_only, n)
    t_gae, d_gae = clock(gae_only, n)
    t_loop, d_loop = clock(fused_step, n)
    t_blocked, d_blocked = clock(fused_blocked, n)
    walls = {"rollout": t_roll, "gae": t_gae, "advantage": t_adv,
             "update": t_upd, "fused_loop": t_loop}
    busy = {"rollout": clock.busy(rollout_only),
            "gae": clock.busy(gae_only),
            "advantage": clock.busy(advantage),
            "update": clock.busy(update_step),
            "fused_loop": clock.busy(fused_step)}
    if args.trace_dir:
        with profiling.trace(args.trace_dir, dev):
            fused_step()

    # the production decomposition (rollout -> advantage -> update); the
    # bare gae row stays as the reference
    t_parts = t_roll + t_adv + t_upd
    pipeline_overlap = max(t_blocked - t_loop, 0.0)
    fwd_evals = B + n_envs                      # rollout + bootstrap value
    upd_evals = ppo.n_epochs * B                # fwd+bwd per sample
    flops = 2 * n_params * (fwd_evals + 3 * upd_evals)
    upd_flops = 2 * n_params * 3 * upd_evals

    def ms(x):
        return round(x, 3) if x is not None else None

    out = {
        **context,
        "geometry": {"n_epochs": ppo.n_epochs, "n_minibatches": n_mb,
                     "minibatch_size": mb,
                     "bf16_update": ppo.bf16_update},
        "advantage_pipeline": {"correction": ppo.correction,
                               "reward_norm": ppo.reward_norm,
                               "bf16_advantages": ppo.bf16_advantages},
        "repeats": args.repeats, "iters_per_repeat": n,
        "seconds_per_iteration": {
            "rollout": round(t_roll, 5), "gae": round(t_gae, 5),
            "advantage": round(t_adv, 5),
            "update": round(t_upd, 5), "fused_loop": round(t_loop, 5),
            "fused_step_blocked": round(t_blocked, 5),
            "pipeline_overlap": round(pipeline_overlap, 5)},
        "device_span_ms_per_iteration": {
            "rollout": ms(d_roll), "gae": ms(d_gae),
            "advantage": ms(d_adv), "update": ms(d_upd),
            "fused_loop": ms(d_loop), "fused_step_blocked": ms(d_blocked)},
        "device_busy_ms_per_iteration": {k: ms(v) for k, v in busy.items()},
        "device_busy_share": {
            k: (round(v / 1e3 / walls[k], 3) if v is not None else None)
            for k, v in busy.items()},
        "stage_share_of_parts": {
            "rollout": round(t_roll / t_parts, 3),
            "advantage": round(t_adv / t_parts, 3),
            "update": round(t_upd / t_parts, 3)},
        "parts_over_fused_loop": round(t_parts / t_loop, 3),
        "env_steps_per_sec": round(B / t_loop, 1),
        "policy_params": int(n_params),
        "model_flops_per_sec": round(flops / t_loop, 1),
        "assumed_bf16_peak_flops": peak,
        "mfu_total": (round(flops / t_loop / peak, 6)
                      if peak is not None else None),
        "mfu_update": (round(upd_flops / t_upd / peak, 6)
                       if peak is not None else None),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
