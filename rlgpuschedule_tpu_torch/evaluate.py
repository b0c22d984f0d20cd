"""Evaluation CLI (L6) of the port:
``python -m rlgpuschedule_tpu_torch.evaluate --config <name>``.

Counterpart of the per-window and full-trace tables of the JAX
package's ``evaluate.py``: it builds the config's experiment on the
device, restores the policy from ``--ckpt-dir`` (the step
``--ckpt-step``, else the newest that restores; without it, the seeded
init of ``--seed``, said on stderr), replays its trace windows under the
greedy policy and the masked-uniform random control there, runs the
FIFO, SJF, SRTF and Tiresias baselines over the same windows on the
host (:func:`..eval.jct_report`), prints the table on stderr and one
JSON line on stdout: the numeric rows, ``percentiles`` with
``--percentiles``, the baseline backend, the wall time of each part, the
device, and a ``repro`` block of the config fields and the checkpoint
step that regenerate it. ``--full-trace`` replaces the windows by the
whole source trace, stitched through the job table
(:func:`..eval.full_trace_report`); ``--fairness`` prints the
multi-tenant fairness table instead (:func:`..eval.fairness_report`:
per-tenant avg JCT and Jain's index, policy against the baselines; its
JSON writes NaN as null); ``--drain-frac`` evaluates on
backlog-drain copies of that fraction of the windows. ``--pbt``
restores a PBT population of ``--n-pop`` members from ``--ckpt-dir``
and replays its fittest member (by the saved controller's fitness
window), or ``--member``, per window; a hierarchical config (config 5,
``hier-pbt-member``) replays per window with or without it.

Faults and domains (flat configs): ``--faults``/``--domains`` name the
regime a checkpoint was trained under (its health and geometry
channels are part of its observation); the evaluation stays on the
clean fixed cluster unless asked otherwise. ``--chaos`` prints the
fault regime x scheduler matrix (:func:`..eval.chaos_report`),
``--matrix`` the train regime x eval regime generalization matrix
(:func:`..eval.matrix_report`, ``--matrix-ckpt REGIME=DIR`` adds rows),
and ``--full-trace --stitch-faults/--stitch-domain`` runs the whole
stitched table under one seeded global-time schedule. ``--obs-dir``
writes the chaos or matrix table's cell events and gauges there
(``metrics.prom``), ``--trace-spans`` the chaos table's spans, and
``--alarms`` runs the matrix cells under the recompile and transfer
alarms (:class:`..obs.Alarms`). Every other flag of the JAX CLI exits
naming the slice it waits for.

Examples::

    python -m rlgpuschedule_tpu_torch.evaluate --config ppo-cnn-philly512 \\
        --eval-windows 8 --max-steps 4096 --percentiles
    python -m rlgpuschedule_tpu_torch.evaluate --config ppo-mlp-synth64 \\
        --ckpt-dir out/run --seed 123 --drain-frac 1.0
    python -m rlgpuschedule_tpu_torch.evaluate --config ppo-mlp-synth64 \\
        --ckpt-dir out/run --seed 123 --full-trace --stitch-drain-jobs 8
    python -m rlgpuschedule_tpu_torch.evaluate --config ppo-mlp-synth64 \\
        --baselines-only --device cpu
    python -m rlgpuschedule_tpu_torch.evaluate --config a2c-pai-fair \\
        --ckpt-dir out/fair --fairness
    python -m rlgpuschedule_tpu_torch.evaluate --config hier-pbt-member \\
        --pbt --n-pop 4 --ckpt-dir out/pbt
    python -m rlgpuschedule_tpu_torch.evaluate --config ppo-mlp-synth64 \\
        --faults storm --ckpt-dir out/storm --chaos
    python -m rlgpuschedule_tpu_torch.evaluate --config ppo-mlp-synth64 \\
        --domains mixed --ckpt-dir out/mixed --matrix \\
        --matrix-ckpt clean=out/run --obs-dir out/obs --alarms
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys

import torch

from .checkpoint import Checkpointer
from .cli import (add_config_flags, check_source_jobs, config_overrides,
                  numeric_rows, refuse_unported)
from .configs import (CONFIGS, ModeCombinationError, repro_tuple,
                      validate_mode_combination)
from .device import resolve_device
from .eval import (baseline_jct_table, check_modes, fairness_report,
                   format_fairness, format_report, full_trace_report,
                   jct_report)
from .domains import (DOMAIN_REGIMES, domain_schedule, domain_stats,
                      sample_domain)
from .eval import (CHAOS_REGIMES, MATRIX_REGIMES, chaos_report,
                   format_chaos, format_matrix, matrix_report)
from .experiment import (Experiment, PopulationExperiment,
                         build_env_params, load_source_trace,
                         make_env_windows, trace_sim)
from .obs import PROM_SNAPSHOT, Alarms, EventBus, Registry, Tracer
from .sim.core import validate_trace
from .sim.faults import FAULT_REGIMES, fault_horizon, sample_fault_schedule
from .sim.schedulers import BASELINES

# tail-latency columns --percentiles adds (keep the flag's help in sync)
PERCENTILES = (50, 90, 99)

_Q1 = "ROADMAP.md queue 1"
# the JAX CLI's flags that this port does not take, and what they wait for
UNPORTED_FLAGS: dict[str, str] = {
    # a no-op switch here: the guard is on unless --no-stall-guard
    "--stall-guard": "a caller that needs it (ROADMAP.md, \"Deliberately "
                     "unported\"); the guard is on by default",
}


def _json_safe(v):
    """NaN (the fairness table's nothing-completed value) as null: bare
    NaN tokens are not JSON."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_json_safe(x) for x in v]
    return v


def _names(arg: str | None) -> tuple[str, ...]:
    return tuple(x for x in (arg or "").split(",") if x)


def check_chaos_flags(args, cfg) -> "dict | None":
    """Exit on a misused chaos, matrix or stitch flag, in the JAX CLI's
    words; returns the ``--matrix`` settings (``regimes``,
    ``baselines``, ``ckpts``), or None without ``--matrix``."""
    for flag, name, known in (("--faults", cfg.faults, FAULT_REGIMES),
                              ("--domains", cfg.domains, DOMAIN_REGIMES)):
        if name is not None and name not in known:
            sys.exit(f"unknown {flag} regime {name!r}; known: "
                     f"{sorted(known)}")
    excl = (args.pbt or args.fairness or args.full_trace
            or args.baselines_only or args.percentiles or args.backlog_gate
            or cfg.n_pods > 1)
    if args.chaos:
        if excl or args.matrix:
            sys.exit("--chaos is its own regime × scheduler matrix over "
                     "the window batch (flat configs): no --pbt/"
                     "--fairness/--full-trace/--baselines-only/"
                     "--percentiles/--backlog-gate")
        if args.eval_windows is not None:
            sys.exit("--chaos replays the experiment's window batch; "
                     "size it with --n-envs")
        bad = [r for r in _names(args.chaos_regimes)
               if r not in FAULT_REGIMES]
        if bad:
            sys.exit(f"unknown --chaos-regimes {bad}; known: "
                     f"{sorted(FAULT_REGIMES)}")
        bad = [b for b in _names(args.chaos_baselines) if b not in BASELINES]
        if bad:
            sys.exit(f"unknown --chaos-baselines {bad}; known: "
                     f"{sorted(BASELINES)}")
    elif args.chaos_regimes is not None:
        sys.exit("--chaos-regimes configures the --chaos matrix; pass "
                 "--chaos with it (refusing the silent no-op)")
    if args.obs_dir and not (args.chaos or args.matrix):
        sys.exit("--obs-dir serves the --chaos and --matrix flows; pass "
                 "one of them with it (refusing the silent no-op)")
    if args.trace_spans and not (args.chaos and args.obs_dir):
        sys.exit("--trace-spans records spans on the chaos event bus; "
                 "pass --chaos and --obs-dir with it (refusing the "
                 "silent no-op)")
    matrix = None
    if args.matrix:
        if excl:
            sys.exit("--matrix is its own train-regime × eval-regime "
                     "table over generated domain windows (flat "
                     "configs): no --chaos/--pbt/--fairness/"
                     "--full-trace/--baselines-only/--percentiles/"
                     "--backlog-gate")
        if args.eval_windows is not None:
            sys.exit("--matrix generates its own window batch per "
                     "regime; size it with --n-envs")
        regimes = _names(args.matrix_regimes)
        bad = [r for r in regimes if r not in DOMAIN_REGIMES]
        if bad:
            sys.exit(f"unknown --matrix-regimes {bad}; known: "
                     f"{sorted(DOMAIN_REGIMES)}")
        baselines = _names(args.matrix_baselines)
        bad = [b for b in baselines if b not in BASELINES]
        if bad:
            sys.exit(f"unknown --matrix-baselines {bad}; known: "
                     f"{sorted(BASELINES)}")
        ckpts = []
        for spec in args.matrix_ckpt or []:
            regime, sep, path = spec.partition("=")
            if not sep or not path or (regime != "clean" and
                                       regime not in DOMAIN_REGIMES):
                sys.exit(f"--matrix-ckpt wants REGIME=DIR with REGIME "
                         f"in {sorted(DOMAIN_REGIMES)} or 'clean' "
                         f"(got {spec!r})")
            ckpts.append((regime, path))
        matrix = {"regimes": regimes or MATRIX_REGIMES,
                  "baselines": baselines, "ckpts": ckpts}
    elif (args.matrix_regimes is not None or args.matrix_ckpt
          or args.matrix_seed != 0 or args.alarms):
        sys.exit("--matrix-regimes/--matrix-ckpt/--matrix-seed/--alarms "
                 "configure the --matrix table; pass --matrix with them "
                 "(refusing the silent no-op)")
    if args.alarms and not args.obs_dir:
        sys.exit("--alarms raises its events on the --obs-dir bus; pass "
                 "--obs-dir with it")
    if (args.stitch_faults or args.stitch_domain) and not args.full_trace:
        sys.exit("--stitch-faults/--stitch-domain degrade the "
                 "--full-trace stitched replay; pass --full-trace with "
                 "them (refusing the silent no-op)")
    if args.stitch_seed != 0 and not (args.stitch_faults or
                                      args.stitch_domain):
        sys.exit("--stitch-seed seeds the --stitch-faults/--stitch-domain "
                 "draw; pass one of them with it")
    for flag, name, known in (("--stitch-faults", args.stitch_faults,
                               FAULT_REGIMES),
                              ("--stitch-domain", args.stitch_domain,
                               DOMAIN_REGIMES)):
        if name is not None and name not in known:
            sys.exit(f"unknown {flag} {name!r}; known: {sorted(known)}")
    return matrix


def stitch_schedule(args, cfg, source, repro: dict):
    """The one global-time schedule of ``--stitch-faults`` and/or
    ``--stitch-domain`` (seeded ``(--stitch-seed,)`` over the source's
    fault horizon), or None; records the draw in ``repro``."""
    if not (args.stitch_faults or args.stitch_domain):
        return None
    schedule = None
    if args.stitch_faults:
        schedule = sample_fault_schedule(
            cfg.n_nodes, args.stitch_faults, (args.stitch_seed,),
            fault_horizon([source]))
    if args.stitch_domain:
        draw = sample_domain(args.stitch_domain, cfg.n_nodes,
                             cfg.gpus_per_node, (args.stitch_seed,))
        schedule = domain_schedule(draw, schedule)
        repro["stitch_domain_draw"] = domain_stats(draw)
    repro.update(stitch_faults=args.stitch_faults,
                 stitch_domain=args.stitch_domain,
                 stitch_seed=args.stitch_seed)
    return schedule


def _print_json(report: dict, dev: torch.device) -> dict:
    """Print a chaos or matrix report as one JSON line, with the device,
    and return it."""
    out = dict(report, device=str(dev),
               device_name=(torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"))
    print(json.dumps(_json_safe(out)), flush=True)
    return report


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
    p.add_argument("--drain-frac", type=float, default=None,
                   help="evaluate on backlog-drain copies of this fraction "
                        "of the windows (all jobs at t=0), the regime the "
                        "drain curriculum trains on; 1.0 gives the "
                        "BASELINE.md drain tables")
    p.add_argument("--ckpt-dir", default=None,
                   help="restore the policy from this checkpoint dir "
                        "(cluster, queue and observation flags must match "
                        "the training run's)")
    p.add_argument("--ckpt-step", type=int, default=None,
                   help="the checkpoint step to restore (default: the "
                        "newest that restores)")
    p.add_argument("--max-steps", type=int, default=None,
                   help="decision steps per window (default: the horizon)")
    p.add_argument("--eval-windows", type=int, default=None,
                   help="evaluate on this many windows of the config's "
                        "tiling instead of --n-envs")
    p.add_argument("--percentiles", action="store_true",
                   help="add p50/p90/p99 JCT columns per scheduler")
    p.add_argument("--pbt", action="store_true",
                   help="evaluate a PBT population checkpoint (config 5): "
                        "restores the population from --ckpt-dir and "
                        "replays one member")
    p.add_argument("--n-pop", type=int, default=4,
                   help="with --pbt: population size of the training run")
    p.add_argument("--member", type=int, default=None,
                   help="with --pbt: member index to evaluate (default: "
                        "fittest by the controller's windowed fitness)")
    p.add_argument("--baselines-only", action="store_true")
    p.add_argument("--fairness", action="store_true",
                   help="multi-tenant fairness table: per-tenant avg JCT "
                        "+ Jain index, policy vs baselines (config 3)")
    p.add_argument("--full-trace", action="store_true",
                   help="evaluate over the entire source trace: the policy "
                        "by sequential windowed replay with residual "
                        "carry, the baselines over the same trace")
    p.add_argument("--max-jobs", type=int, default=None,
                   help="with --full-trace: cap the source trace at the "
                        "first N jobs")
    p.add_argument("--stitch-window-jobs", type=int, default=None,
                   help="with --full-trace: stitch through a job table of "
                        "this size instead of the training window_jobs "
                        "(the policy does not depend on the table's "
                        "size), widening the backlog held between seams")
    p.add_argument("--stitch-drain-jobs", type=int, default=1,
                   help="with --full-trace: in deep-backlog mode, free "
                        "this many job-table rows per stitched window "
                        "instead of 1 before ingesting fresh jobs (fewer "
                        "windows on an overloaded stream; 1 reproduces "
                        "the recorded tables)")
    p.add_argument("--no-random", action="store_true",
                   help="skip the random-policy row")
    p.add_argument("--backlog-gate", type=int, default=0,
                   help="evaluate the backlog-gated hybrid: while fewer "
                        "than N jobs are pending, play FIFO-with-backfill "
                        "instead of the policy (policy row only)")
    p.add_argument("--faults", default=None, metavar="REGIME",
                   help="the fault regime the checkpoint was trained under "
                        "(its health channel is part of the observation); "
                        "the evaluation stays clean unless --chaos")
    p.add_argument("--domains", default=None, metavar="REGIME",
                   help="the domain regime the checkpoint was trained "
                        "under (its geometry and health channels are part "
                        "of the observation); the evaluation stays on the "
                        "fixed cluster unless --matrix")
    p.add_argument("--chaos", action="store_true",
                   help="chaos matrix: the policy and the baselines under "
                        "the same seeded fault schedules per regime (none, "
                        "sporadic drains, drain storms, stragglers), with "
                        "each cell's degradation against the clean row")
    p.add_argument("--chaos-regimes", default=None, metavar="A,B,...",
                   help="with --chaos: the regimes (the clean 'none' is "
                        "always included)")
    p.add_argument("--chaos-baselines", default="sjf,tiresias",
                   metavar="A,B,...",
                   help="with --chaos: the baseline columns")
    p.add_argument("--chaos-seed", type=int, default=0,
                   help="with --chaos: base seed of the schedules (env e "
                        "draws (seed, e))")
    p.add_argument("--matrix", action="store_true",
                   help="generalization matrix: the policy (and any "
                        "--matrix-ckpt rows) and the baselines under the "
                        "same seeded domain draws per eval regime, with "
                        "each cell's degradation against the fixed cluster")
    p.add_argument("--matrix-regimes", default=None, metavar="A,B,...",
                   help="with --matrix: the eval regimes (the fixed-cluster "
                        "'none' is always included)")
    p.add_argument("--matrix-baselines", default="sjf,tiresias",
                   metavar="A,B,...",
                   help="with --matrix: the baseline rows")
    p.add_argument("--matrix-seed", type=int, default=0,
                   help="with --matrix: base seed of the draws and the "
                        "generated windows (env e draws (seed, e))")
    p.add_argument("--matrix-ckpt", action="append", default=None,
                   metavar="REGIME=DIR",
                   help="with --matrix: add a row restored from DIR, trained "
                        "under --domains REGIME ('clean' for none); "
                        "repeatable")
    p.add_argument("--alarms", action="store_true",
                   help="with --matrix --obs-dir: production alarm scope "
                        "over the matrix cells — a post-warmup program "
                        "build or a host sync inside a cell's replay "
                        "becomes an alarm event (obs.report "
                        "--strict-alarms gates on them)")
    p.add_argument("--obs-dir", default=None,
                   help="with --chaos/--matrix: emit per-cell events "
                        "(env_fault / domain_cell, JSONL event bus) and "
                        "chaos_*/matrix_* gauges (metrics.prom) under "
                        "this directory so obs.report can tell the "
                        "story")
    p.add_argument("--trace-spans", action="store_true",
                   help="with --chaos --obs-dir: flight recorder — "
                        "record each regime row as nested "
                        "chaos_regime/policy_replay/baseline spans on "
                        "the event bus (export via obs.report "
                        "--trace-out). NOT --trace, which would be the "
                        "workload trace source")
    p.add_argument("--stitch-faults", default=None, metavar="REGIME",
                   help="with --full-trace: run the whole stitched table "
                        "under one seeded global-time fault schedule of "
                        "this regime")
    p.add_argument("--stitch-domain", default=None, metavar="REGIME",
                   help="with --full-trace: run the whole stitched table "
                        "on one seeded domain draw of this regime (composes "
                        "with --stitch-faults: the worst slowdown wins)")
    p.add_argument("--stitch-seed", type=int, default=0,
                   help="with --stitch-faults/--stitch-domain: seed of the "
                        "draw")
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
    over = config_overrides(args)
    for k in ("drain_frac", "faults", "domains"):
        if getattr(args, k) is not None:
            over[k] = getattr(args, k)
    cfg = dataclasses.replace(CONFIGS[args.config], **over)
    check_source_jobs(args, cfg)
    try:
        validate_mode_combination({"pbt": args.pbt,
                                   "faults": cfg.faults is not None,
                                   "domains": cfg.domains is not None})
    except ModeCombinationError as e:
        sys.exit(str(e))
    matrix = check_chaos_flags(args, cfg)
    if args.member is not None and not args.pbt:
        sys.exit("--member picks a member of a --pbt population; pass "
                 "--pbt with it")
    if args.n_pop < 1:
        sys.exit("--n-pop must be >= 1")
    if args.percentiles and (args.fairness or args.baselines_only
                             or args.pbt):
        sys.exit("--percentiles applies to the per-window and --full-trace "
                 "JCT tables (flat configs, no --fairness/"
                 "--baselines-only/--pbt)")
    if args.eval_windows is not None and (args.pbt or args.fairness or
                                          args.full_trace or
                                          args.baselines_only):
        sys.exit("--eval-windows applies to the plain per-window JCT "
                 "table (population views carry no source trace; the "
                 "other modes define their own window batch)")
    if args.stitch_window_jobs is not None and not args.full_trace:
        sys.exit("--stitch-window-jobs applies to --full-trace stitched "
                 "replay only")
    if args.stitch_drain_jobs != 1 and not args.full_trace:
        sys.exit("--stitch-drain-jobs applies to --full-trace stitched "
                 "replay only")
    if args.stitch_drain_jobs < 1:
        sys.exit("--stitch-drain-jobs must be >= 1 (each deep-backlog "
                 "window must free at least one job-table row)")
    if args.backlog_gate < 0:
        sys.exit("--backlog-gate must be >= 0 (a negative gate would "
                 "silently run ungated)")
    if args.backlog_gate and (args.pbt or args.fairness or
                              args.baselines_only or cfg.n_pods > 1):
        sys.exit("--backlog-gate applies to the flat per-window and "
                 "--full-trace policy tables (the hierarchical action "
                 "space has no single FIFO fall-through action; "
                 "--baselines-only has no policy row)")
    if not args.stall_guard and (args.baselines_only or args.fairness
                                 or cfg.n_pods > 1
                                 or cfg.preempt_len == 0):
        sys.exit("--no-stall-guard applies to flat PREEMPTIVE configs' "
                 "policy rows (per-window, --full-trace, and flat --pbt "
                 "members): the guard only ever masks preempt actions, "
                 "so it is a no-op elsewhere, and the fairness path "
                 "does not plumb it; refusing beats silently changing "
                 "nothing)")
    dev = resolve_device(args.device)
    repro = repro_tuple(cfg, ckpt_dir=args.ckpt_dir)

    try:
        # the library's refusals, before anything is built
        check_modes(build_env_params(cfg), full_trace=args.full_trace,
                    fairness=args.fairness,
                    percentiles=PERCENTILES if args.percentiles else None)
        if args.baselines_only:
            sim = trace_sim(build_env_params(cfg))
            windows = make_env_windows(cfg, validate_trace(
                sim, load_source_trace(cfg), clamp=True))
            report = baseline_jct_table(windows, cfg.n_nodes,
                                        cfg.gpus_per_node)
            print(format_report(report), file=sys.stderr)
            print(json.dumps({**report, "repro": repro}), flush=True)
            return report
        if args.pbt and (args.fairness or args.full_trace):
            sys.exit("--pbt supports the per-window JCT table "
                     "(hierarchical members replay per-window)")
        exp = (PopulationExperiment.build(cfg, n_pop=args.n_pop,
                                          device=dev)
               if args.pbt else Experiment.build(cfg, device=dev))
        if args.ckpt_dir:
            with Checkpointer(os.path.abspath(args.ckpt_dir)) as ckpt:
                exp.restore_checkpoint(ckpt, step=args.ckpt_step,
                                       train=False)
            # resolved, not requested: the integrity fallback may restore
            # an older retained step than asked for
            repro["ckpt_step"] = ckpt.last_restored_step
            print(f"{'population' if args.pbt else 'policy'} restored "
                  f"from {args.ckpt_dir} (step {repro['ckpt_step']})",
                  file=sys.stderr)
        else:
            print("note: no --ckpt-dir; evaluating untrained init weights",
                  file=sys.stderr)
        if args.pbt:
            # an untrained population has no fitness record to rank by
            member = args.member if args.member is not None else \
                (None if args.ckpt_dir else 0)
            exp = exp.member_eval_view(member)
            repro["member"] = exp.member
            print(f"evaluating member {exp.member} of {args.n_pop}",
                  file=sys.stderr)
    except (NotImplementedError, ValueError) as e:
        sys.exit(str(e))
    if args.chaos:
        bus = registry = tracer = None
        if args.obs_dir:
            bus = EventBus(os.path.abspath(args.obs_dir), rank=0,
                           name="chaos")
            registry = Registry()
            if args.trace_spans:
                tracer = Tracer(bus, enabled=True)
        try:
            report = chaos_report(
                exp, regimes=_names(args.chaos_regimes) or CHAOS_REGIMES,
                baselines=_names(args.chaos_baselines),
                max_steps=args.max_steps, seed=args.chaos_seed, bus=bus,
                registry=registry, tracer=tracer)
        finally:
            if bus is not None:
                bus.close()
        if registry is not None:
            registry.write(os.path.join(os.path.abspath(args.obs_dir),
                                        PROM_SNAPSHOT))
        print(format_chaos(report), file=sys.stderr)
        report["repro"] = dict(
            repro, chaos_seed=args.chaos_seed,
            chaos_regimes=report["chaos_regimes"],
            chaos_baselines=list(_names(args.chaos_baselines)))
        return _print_json(report, dev)
    if matrix is not None:
        # the experiment's own row, labelled by its training regime
        policies = {cfg.domains or "clean": (exp.net, exp.env_params)}
        try:
            for regime, path in matrix["ckpts"]:
                label = (regime if regime not in policies
                         else f"{regime}@{len(policies)}")
                rexp = Experiment.build(dataclasses.replace(
                    cfg, domains=None if regime == "clean" else regime),
                    device=dev)
                with Checkpointer(os.path.abspath(path)) as ck:
                    rexp.restore_checkpoint(ck, train=False)
                print(f"matrix row {label!r} restored from {path}",
                      file=sys.stderr)
                policies[label] = (rexp.net, rexp.env_params)
        except (NotImplementedError, ValueError) as e:
            sys.exit(str(e))
        bus = registry = alarms = None
        if args.obs_dir:
            bus = EventBus(os.path.abspath(args.obs_dir), rank=0,
                           name="matrix")
            registry = Registry()
            if args.alarms:
                alarms = Alarms(bus, registry, warmup_iters=1,
                                transfer_guard=True, device=dev)
        try:
            with (alarms if alarms is not None
                  else contextlib.nullcontext()):
                report = matrix_report(
                    exp, regimes=matrix["regimes"],
                    baselines=matrix["baselines"], policies=policies,
                    max_steps=args.max_steps, seed=args.matrix_seed,
                    bus=bus, registry=registry, alarms=alarms)
        finally:
            if bus is not None:
                bus.close()
        if registry is not None:
            registry.write(os.path.join(os.path.abspath(args.obs_dir),
                                        PROM_SNAPSHOT))
        print(format_matrix(report), file=sys.stderr)
        report["repro"] = dict(
            repro, matrix_seed=args.matrix_seed,
            matrix_regimes=report["matrix_regimes"],
            matrix_baselines=list(matrix["baselines"]),
            matrix_ckpts=[f"{r}={p}" for r, p in matrix["ckpts"]])
        return _print_json(report, dev)
    if args.fairness:
        report = fairness_report(exp, max_steps=args.max_steps)
        print(format_fairness(report), file=sys.stderr)
        out = _json_safe({**report, "repro": repro})
        out.update(device=str(dev),
                   device_name=(torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"))
        print(json.dumps(out), flush=True)
        return report
    if args.full_trace:
        stitch_params = None
        if args.stitch_window_jobs is not None:
            stitch_params = dataclasses.replace(
                exp.env_params, sim=dataclasses.replace(
                    exp.env_params.sim, max_jobs=args.stitch_window_jobs))
        report = full_trace_report(
            exp, max_jobs=args.max_jobs, include_random=not args.no_random,
            percentiles=PERCENTILES if args.percentiles else None,
            env_params=stitch_params, backlog_gate=args.backlog_gate,
            stall_guard=args.stall_guard,
            drain_completions=args.stitch_drain_jobs,
            faults=stitch_schedule(args, cfg, exp.source, repro))
    else:
        windows = None
        if args.eval_windows is not None and \
                args.eval_windows != cfg.n_envs:
            # the restored tiling cursor, so that a resized batch replays
            # the part of the trace the default one would
            windows = make_env_windows(
                dataclasses.replace(cfg, n_envs=args.eval_windows),
                exp.source, start=exp.window_cursor)
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
