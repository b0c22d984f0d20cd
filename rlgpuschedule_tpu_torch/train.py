"""Training CLI (L6) of the port:
``python -m rlgpuschedule_tpu_torch.train --config <name>``.

Counterpart of the JAX package's ``train.py`` for single-run PPO and
A2C (``--config a2c-pai-fair``). It takes the subset of that CLI's
flags this port implements; every other flag of the JAX CLI is refused
with a message that names the slice it waits for, and a refused pair of
modes with the JAX CLI's message (:data:`..configs.MODE_REFUSALS`). One
JSON line per logged iteration, one per ``--eval-every``
probe (its keys start with ``eval_``), then a summary line with
env-steps/s, the device it ran on and, with ``--report``, the
JCT-vs-baselines table (also printed on stderr).

``--pbt`` trains a PBT population of ``--n-pop`` members, exploiting
every ``--pbt-ready`` iterations (:class:`..experiment
.PopulationExperiment`; config 5, ``hier-pbt-member``, the hierarchical
4-pod agent, runs with or without it). Its logged rows carry one column
per member and the mean; ``--eval-every``, ``--keep-best`` and
``--report`` follow the fittest member (:class:`FittestMemberView`).

``--ckpt-dir`` keeps the last ``--ckpt-keep`` checkpoints, written every
``--ckpt-every`` iterations and at the last (:mod:`.checkpoint`);
``--resume`` restores the newest that loads and trains ``--iterations``
more, its iterations numbered on from the checkpoint's; ``--keep-best``
also saves the policy whenever the held-out probe improves, under
``<ckpt-dir>/best``. ``--drain-frac`` trains that fraction of the envs
on backlog-drain windows; ``--resample-every`` re-cuts the windows from
the source trace every N iterations. ``--bf16-update``,
``--reward-norm`` and ``--bf16-advantages`` set the algorithm's
precision and advantage options, ``--correction`` PPO's (``vtrace``
needs ``--async``); ``--fused-chunk N`` runs
N iterations between hook boundaries with no host sync
(:meth:`..experiment.Experiment.run_fused`). ``--faults REGIME`` trains
under seeded per-env fault schedules and ``--domains REGIME`` across
seeded per-env cluster and arrival draws (flat configs see per-node
health and geometry; a population member draws its own schedules).

``--log-csv`` also writes the logged rows as a CSV (appended to on
``--resume``; probe rows to ``<log-csv>.eval.csv``) and ``--tb-dir`` as a
TensorBoard event file (:mod:`.utils.logging`); ``--obs-dir`` writes the
run's event stream and ``metrics.prom`` (:class:`.obs.RunTelemetry`),
with ``--trace-spans`` its phase spans and with ``--alarms`` the
recompile and transfer alarms (``--alarm-slow-iter S``: a slower
iteration is an alarm and the next one is profiled under
``<obs-dir>/profile``); ``--profile-dir`` traces the run with the torch
profiler and ``--debug-nans`` raises at the first operation that makes
a NaN (:mod:`.utils.profiling`; not with ``--alarms``).

``--async`` trains with the async actor-learner engine
(:meth:`..experiment.Experiment.run_async`, or the population's with
``--pbt``): the rollout on one CUDA stream overlaps the update on
another, through a queue of ``--queue-capacity`` batches, each at most
``--staleness-bound`` policy versions behind (0: the sync loop bit for
bit). Both roles share the ``--device`` card unless
``--actor-devices``/``--learner-devices`` carve the groups
(:mod:`.parallel.groups`: one card each, unverified).

``--continual LOGDIR`` trains on served traffic instead of simulator
rollouts: the crc-verified flight log under LOGDIR (``serve
--flight-log``) is admitted shard by shard through the importance-ratio
trust region (``--continual-trust``, ``--continual-rho-max``) and
``--iterations`` (default 1) V-trace-corrected PPO learn steps run over
its pseudo-trajectories (:func:`.flywheel.run_continual`); with
``--ckpt-dir`` (and ``--resume``, to start from the incumbent) each step
is saved, the candidate a ``serve --promote`` gates.

Examples::

    python -m rlgpuschedule_tpu_torch.train --config ppo-cnn-philly512 \\
        --iterations 3 --log-every 1
    python -m rlgpuschedule_tpu_torch.train --config ppo-mlp-synth64 \\
        --drain-frac 1.0 --iterations 1500 --ckpt-dir out/run \\
        --ckpt-every 250 --ckpt-keep 6
    python -m rlgpuschedule_tpu_torch.train --config ppo-mlp-synth64 \\
        --n-envs 2 --n-steps 16 --iterations 2 --eval-every 1 --report \\
        --device cpu
    python -m rlgpuschedule_tpu_torch.train --config a2c-pai-fair \\
        --iterations 100 --reward-norm --fused-chunk 10 --log-every 10
    python -m rlgpuschedule_tpu_torch.train --config hier-pbt-member \\
        --pbt --n-pop 4 --pbt-ready 10 --ckpt-dir out/pbt
    python -m rlgpuschedule_tpu_torch.train --config ppo-mlp-synth64 \\
        --continual out/flog --ckpt-dir out/run --resume --iterations 2
    python -m rlgpuschedule_tpu_torch.train --config ppo-mlp-synth64 \\
        --iterations 20 --obs-dir out/obs --alarms --trace-spans \\
        --log-csv out/m.csv --tb-dir out/tb
    python -m rlgpuschedule_tpu_torch.train --config ppo-mlp-synth64 \\
        --async --staleness-bound 4 --queue-capacity 4 \\
        --correction vtrace --iterations 20
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import torch

from . import eval as eval_lib
from .checkpoint import Checkpointer
from .cli import (add_config_flags, check_source_jobs, config_overrides,
                  numeric_rows, refuse_unported)
from .configs import (CONFIGS, ExperimentConfig, ModeCombinationError,
                      validate_mode_combination)
from .device import resolve_device
from .domains import DOMAIN_REGIMES
from .env.env import stack_traces
from .experiment import (Experiment, PopulationExperiment, algo_config,
                         load_source_trace, make_env_windows, trace_sim)
from .parallel import PBTConfig, split_devices
from .parallel.groups import home_device
from .sim.core import validate_trace
from .sim.faults import FAULT_REGIMES

_Q1 = "ROADMAP.md queue 1"
# the JAX CLI's flags that this port does not take, and what they wait for
UNPORTED_FLAGS: dict[str, str] = dict.fromkeys(
    ("--mesh", "--max-rollbacks", "--fault"),
    f"the data-parallel and resilience slice ({_Q1}, item 21)")


# the port's one refusal of a pair the JAX CLI takes: the NaN check of
# --debug-nans reads each operation's output on the host, a sync that
# the --alarms guard forbids inside the train step on the card (JAX's
# check is not an implicit transfer, so its guard lets it through)
DEBUG_NANS_WITH_ALARMS = (
    "--debug-nans reads every operation's output back to the host, a "
    "sync that the --alarms transfer guard forbids inside the train step "
    "on the card; run the NaN check and the alarms in separate runs")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m rlgpuschedule_tpu_torch.train",
        description="Train an RL GPU-cluster scheduling policy with PPO "
                    "or A2C (PyTorch, on the GPU unless --device says "
                    "otherwise).")
    p.add_argument("--config", default="ppo-mlp-synth64",
                   help="named preset (see --list-configs)")
    p.add_argument("--list-configs", action="store_true")
    # config overrides (None = keep the preset's value)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--n-envs", type=int, default=None)
    add_config_flags(p)
    p.add_argument("--resample-every", type=int, default=None,
                   help="window streaming: rotate env windows over the "
                        "source trace every N iterations (0 = static)")
    p.add_argument("--drain-frac", type=float, default=None,
                   help="backlog-drain curriculum: fraction of envs that "
                        "train on drained copies of their windows (all "
                        "jobs at t=0)")
    p.add_argument("--faults", default=None, metavar="REGIME",
                   help="cluster chaos: train under seeded per-env fault "
                        "schedules of this regime (none, sporadic, storm, "
                        "straggler); a flat config also sees per-node "
                        "health. Not with a hierarchical config")
    p.add_argument("--domains", default=None, metavar="REGIME",
                   help="domain randomization: train across seeded per-env "
                        "cluster geometry, hardware speed and arrival "
                        "draws of this regime (none, baseline, geom, "
                        "hetero, overload, flash, mixed); a flat config "
                        "also sees per-node capacity and health. Composes "
                        "with --faults (the worst slowdown wins per node)")
    p.add_argument("--n-steps", type=int, default=None,
                   help="rollout length T per iteration")
    p.add_argument("--n-epochs", type=int, default=None,
                   help="update epochs per iteration")
    p.add_argument("--n-minibatches", type=int, default=None,
                   help="minibatches per update epoch")
    p.add_argument("--minibatch-size", type=int, default=None,
                   help="explicit minibatch size (overrides "
                        "--n-minibatches; must tile n_steps * n_envs)")
    p.add_argument("--bf16-update", action="store_true", default=None,
                   help="bf16-compute / fp32-optimizer-state update path "
                        "(NOT bit-identical to the fp32 default)")
    p.add_argument("--correction", default=None,
                   choices=["none", "vtrace"],
                   help="off-policy advantage correction (PPO only). "
                        "'vtrace' re-weights the advantage scan by "
                        "rho/c-clipped importance ratios (algos.vtrace) "
                        "so deep --staleness-bound queues train without "
                        "bias; requires --async (on-policy ratios are "
                        "identically 1 and the correction reduces "
                        "bit-identically to the GAE path, so the sync "
                        "combination is refused as a silent no-op)")
    p.add_argument("--reward-norm", action="store_true", default=None,
                   help="streaming reward standardization: scale rewards "
                        "by a running inverse-std (Welford moments "
                        "carried in the train state, scale-only — no "
                        "centering, so sparse-reward signs survive) "
                        "before the advantage scan")
    p.add_argument("--bf16-advantages", action="store_true", default=None,
                   help="store advantage/return targets in bfloat16 "
                        "between the advantage scan and the minibatch "
                        "epochs (halves the target buffer; NOT "
                        "bit-identical — loss math upcasts to fp32)")
    # async actor-learner split (async_engine; opt-in)
    p.add_argument("--async", dest="async_run", action="store_true",
                   help="overlapped actor-learner engine: rollout "
                        "collection on one CUDA stream (or device) "
                        "overlaps the minibatch update on another, coupled "
                        "by a bounded trajectory queue (Sebulba split). "
                        "--staleness-bound 0 reproduces the sync loop "
                        "bit-identically; with --pbt the population")
    p.add_argument("--actor-devices", default=None, metavar="N|I,J,..",
                   help="with --async: actor group as a device COUNT "
                        "(taken from the front of the visible list) or "
                        "explicit comma-separated device indices. "
                        "Default (neither group flag): both roles share "
                        "the --device card; with one flag alone the "
                        "other group takes the remaining devices")
    p.add_argument("--learner-devices", default=None, metavar="N|I,J,..",
                   help="with --async: learner group (count from the "
                        "back, or explicit indices; must be disjoint "
                        "from the actor group unless identical)")
    p.add_argument("--staleness-bound", type=int, default=1,
                   help="with --async: max update-steps the policy that "
                        "collected a batch may lag the learner at "
                        "consume time (0 = lock-step, bit-identical to "
                        "the sync path; default 1). Bounds >= 4 run the "
                        "queue deep enough to hide slow actors but bias "
                        "the clip-only surrogate: pair them with "
                        "--correction vtrace")
    p.add_argument("--queue-capacity", type=int, default=2,
                   help="with --async: trajectory-queue slots; a full "
                        "queue blocks the actor (backpressure, no drops)")
    p.add_argument("--fused-chunk", type=int, default=1,
                   help="run N train steps with no host sync between hook "
                        "boundaries (every active log/eval/ckpt/resample "
                        "cadence, the iteration count and a resumed "
                        "run's start must be multiples of N)")
    p.add_argument("--pbt", action="store_true",
                   help="train a PBT population instead of a single run")
    p.add_argument("--n-pop", type=int, default=4)
    p.add_argument("--pbt-ready", type=int, default=10,
                   help="iterations between exploit/explore rounds")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--ent-coef", type=float, default=None)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--eval-every", type=int, default=0,
                   help="every N iterations (and at the last), replay the "
                        "policy greedily on a small held-out window batch "
                        "and log its avg JCT and eval_vs_tiresias")
    p.add_argument("--eval-windows", type=int, default=4,
                   help="held-out windows per --eval-every probe")
    p.add_argument("--eval-seed", type=int, default=None,
                   help="seed of the held-out eval trace (default: "
                        "training seed + 1000)")
    p.add_argument("--eval-probe", default="auto",
                   choices=["auto", "drain", "stream"],
                   help="probe regime: auto = drain for drain-curriculum "
                        "configs (--drain-frac > 0), else streaming. Use "
                        "'stream' when the deliverable is a streaming or "
                        "full-trace table: drain quality does not rank "
                        "streaming quality")
    p.add_argument("--keep-best", action="store_true",
                   help="with --eval-every and --ckpt-dir: whenever the "
                        "held-out probe's avg JCT improves (at full "
                        "completion), save a checkpoint under "
                        "<ckpt-dir>/best")
    p.add_argument("--log-csv", default=None)
    p.add_argument("--tb-dir", default=None,
                   help="also write scalar curves as a TensorBoard event "
                        "file under this directory")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--ckpt-keep", type=int, default=None,
                   help="retain the last N periodic checkpoints (default "
                        "3); keep a series to rank afterwards with "
                        "select_checkpoint on a validation stream")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint from --ckpt-dir")
    p.add_argument("--continual", default=None, metavar="LOGDIR",
                   help="continual training: instead of simulator "
                        "rollouts, ingest the crc-verified served-traffic "
                        "flight log under LOGDIR (serve --flight-log) and "
                        "run --iterations (default 1) V-trace-corrected "
                        "updates over its pseudo-trajectories; shards "
                        "outside the trust region are refused. Composes "
                        "with --ckpt-dir/--resume (restore the incumbent, "
                        "retrain, save the candidate)")
    p.add_argument("--continual-trust", type=float, default=2.0,
                   help="ingest trust region: refuse shards whose mean "
                        "importance ratio leaves [1/T, T]")
    p.add_argument("--continual-rho-max", type=float, default=8.0,
                   help="ingest trust region: refuse shards whose max "
                        "importance ratio exceeds this")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch profiler trace of the run")
    # observability (obs/): structured event bus + metrics snapshot +
    # production alarms, the run's post-mortem surface
    p.add_argument("--obs-dir", default=None,
                   help="unified telemetry: append structured events "
                        "(JSONL event bus, schema-versioned, rank/pid/"
                        "monotonic-stamped) and a Prometheus-text "
                        "metrics snapshot (metrics.prom) under this "
                        "directory; post-mortem via "
                        "python -m rlgpuschedule_tpu_torch.obs.report <dir>")
    p.add_argument("--alarms", action="store_true",
                   help="production alarms (requires --obs-dir): a "
                        "post-warmup dispatch that builds a program emits "
                        "a recompile event (the silent throughput killer "
                        "the test-only CompileCounter gate catches only "
                        "in CI), and a host<->device sync in the dispatch "
                        "emits a transfer event and fails fast")
    p.add_argument("--alarm-slow-iter", type=float, default=None,
                   metavar="SECONDS",
                   help="with --alarms: an iteration slower than this "
                        "emits a slow_iteration event and auto-captures "
                        "a one-shot torch profiler trace of the NEXT "
                        "iteration under <obs-dir>/profile")
    p.add_argument("--trace-spans", action="store_true",
                   help="flight recorder (requires --obs-dir): record "
                        "nested phase spans (iteration/step/sync/...) on "
                        "the event bus; export with obs.report "
                        "--trace-out trace.json (Perfetto). NOT --trace, "
                        "which picks the workload trace source")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise at the first operation that produces a NaN "
                        "(utils.profiling.debug_checks, the jax_debug_nans "
                        "counterpart; fails fast with a traceback naming "
                        "the operation). Every operation then syncs with "
                        "the card, so not with --alarms")
    p.add_argument("--report", action="store_true",
                   help="print the JCT-vs-baselines table after training "
                        "(stderr) and add it to the summary line")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p


def apply_overrides(cfg: ExperimentConfig,
                    args: argparse.Namespace) -> ExperimentConfig:
    over = config_overrides(args)
    for k in ("iterations", "resample_every", "drain_frac", "faults",
              "domains"):
        if getattr(args, k) is not None:
            over[k] = getattr(args, k)
    cfg = dataclasses.replace(cfg, **over)
    algo_fields = {"lr": args.lr, "ent_coef": args.ent_coef,
                   "n_steps": args.n_steps, "n_epochs": args.n_epochs,
                   "n_minibatches": args.n_minibatches,
                   "minibatch_size": args.minibatch_size,
                   "bf16_update": args.bf16_update,
                   "reward_norm": args.reward_norm,
                   "bf16_advantages": args.bf16_advantages}
    over = {k: v for k, v in algo_fields.items() if v is not None}
    # only PPO has an off-policy correction
    if args.correction is not None:
        if cfg.algo != "ppo":
            sys.exit("--correction selects the PPO advantage pipeline "
                     "(algos.vtrace); the A2C update has no importance-"
                     "corrected variant")
        over["correction"] = args.correction
    if over:
        cfg = dataclasses.replace(
            cfg, **{cfg.algo: dataclasses.replace(algo_config(cfg),
                                                  **over)})
    return cfg


def make_eval_probe(cfg: ExperimentConfig, exp: Experiment, n_windows: int,
                    eval_seed: int | None, regime: str = "auto"):
    """The ``--eval-every`` in-training quality probe: a greedy replay of
    the live policy on a held-out window batch (a fresh trace seed,
    ``cfg.seed + 1000`` unless ``eval_seed``; never trained on), scored
    against the FIFO and Tiresias baselines computed once, here. Returns
    ``eval_fn(i) -> dict`` for :meth:`Experiment.run`.

    ``regime``: ``"auto"`` probes all-drain windows for a
    drain-curriculum config (``cfg.drain_frac > 0``) and all-streaming
    ones otherwise; ``"drain"``/``"stream"`` force one. One regime, never
    a mix: a fractional ``drain_frac`` would pool two incomparable
    numbers. CSV traces have no second trace to hold out: the probe
    replays leading windows of the training CSV (on-distribution), says
    so on stderr, and refuses ``eval_seed``."""
    if regime == "auto":
        regime = "drain" if cfg.drain_frac > 0 else "stream"
    if regime not in ("drain", "stream"):
        raise ValueError(f"unknown probe regime {regime!r}")
    if cfg.trace in ("philly", "pai"):
        if eval_seed is not None:
            raise ValueError("--eval-seed has no effect for csv traces "
                             "(philly/pai load a file, not a seeded "
                             "generator)")
        print("note: --eval-every probe windows come from the training "
              "CSV (csv traces have no held-out seed); treat the curve "
              "as on-distribution quality, not generalization",
              file=sys.stderr)
    seed = cfg.seed + 1000 if eval_seed is None else eval_seed
    # source_jobs=None: the probe's trace is sized to its own windows
    ecfg = dataclasses.replace(cfg, n_envs=n_windows, seed=seed,
                               source_jobs=None,
                               drain_frac=1.0 if regime == "drain" else 0.0)
    sim_params = trace_sim(exp.env_params)
    windows = make_env_windows(ecfg, validate_trace(
        sim_params, load_source_trace(ecfg), clamp=True))
    traces = stack_traces(windows, sim_params, exp.device)
    baselines = eval_lib.baseline_jct_table(
        windows, cfg.n_nodes, cfg.gpus_per_node, names=("fifo", "tiresias"))

    def eval_fn(_i: int) -> dict:
        res = eval_lib.replay(exp.net, exp.env_params, traces)
        jct, completion = eval_lib.pooled_avg_jct(res)
        out = {"eval_avg_jct": jct, "eval_completion": completion,
               **{f"eval_{k}": v for k, v in baselines.items()}}
        if baselines.get("tiresias"):
            out["eval_vs_tiresias"] = jct / baselines["tiresias"]
        return out

    return eval_fn


class FittestMemberView:
    """An :class:`..experiment.Experiment`-like view of a
    :class:`..experiment.PopulationExperiment` for :func:`make_eval_probe`
    and the report: ``net`` is the fittest member's policy at the time it
    is read (a population run calls its probe after recording the
    iteration's fitness), so the probe and ``--keep-best`` follow the
    population's best member rather than a fixed index."""

    def __init__(self, pop: PopulationExperiment):
        self._pop = pop

    def __getattr__(self, name):
        if name == "net":
            return self._pop.members[self._pop.best_member()].net
        return getattr(self._pop, name)


def _keep_best(exp: Experiment, ckpt: Checkpointer, probe, bus=None):
    """Wrap ``probe`` so that each probe whose avg JCT beats the best so
    far, at full completion, saves the experiment under
    ``<ckpt-dir>/best`` (one step kept, its events on ``bus``). A
    resumed run recovers the bar from the saved meta, so its first
    probe cannot rotate out a better policy of the earlier run."""
    best_ckpt = Checkpointer(os.path.join(ckpt.directory, "best"),
                             max_to_keep=1, bus=bus)
    best = {"jct": float("inf")}
    if best_ckpt.latest_step() is not None:
        best["jct"] = float(best_ckpt.read_meta().get("eval_avg_jct",
                                                      float("inf")))
        print(f"keep-best: prior best eval_avg_jct={best['jct']:.1f}",
              file=sys.stderr)

    def keep_best_probe(i: int) -> dict:
        m = dict(probe(i))
        improved = (m["eval_completion"] >= 1.0
                    and m["eval_avg_jct"] < best["jct"])
        if improved:
            # force: a resumed run can revisit a step number best/
            # already holds, and a skipped save would leave stale
            # weights labelled with the new probe's result
            exp.save_checkpoint(best_ckpt,
                                meta={"eval_avg_jct": m["eval_avg_jct"]},
                                force=True)
            best["jct"] = m["eval_avg_jct"]
        m["eval_is_best"] = float(improved)
        return m

    return keep_best_probe


def _continual(args, exp: Experiment, ckpt, telemetry=None) -> dict:
    """``--continual LOGDIR``: the flywheel's retraining in place of the
    simulator loop (its gauges in the telemetry's registry, when there
    is one); one JSON summary line."""
    from .flywheel import FlightLogError, run_continual
    from .obs import Registry
    try:
        summary = run_continual(
            exp, os.path.abspath(args.continual),
            iterations=args.iterations if args.iterations is not None
            else 1, trust=args.continual_trust,
            rho_max_cap=args.continual_rho_max,
            registry=(telemetry.registry if telemetry is not None
                      else Registry()), ckpt=ckpt)
    except FlightLogError as e:
        sys.exit(f"continual ingest refused: {e}")
    dev = exp.device
    summary.update(device=str(dev), device_name=(
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"))
    print(f"continual: {summary['shards_accepted']}/"
          f"{summary['shards_seen']} shards admitted "
          f"({summary['shards_refused']} refused by the trust region), "
          f"{summary['rows_trained']} rows as {summary['pseudo_steps']} "
          f"pseudo-steps x {summary['iterations']} iterations -> step "
          f"{summary['final_step']}", file=sys.stderr)
    print(json.dumps(summary), flush=True)
    return summary


def main(argv: "list[str] | None" = None) -> dict:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    refuse_unported(extra, parser, UNPORTED_FLAGS)
    if args.list_configs:
        for name, c in CONFIGS.items():
            print(f"{name:20s} algo={c.algo} obs={c.obs_kind} "
                  f"cluster={c.n_nodes}x{c.gpus_per_node} trace={c.trace}"
                  f"{' pods=' + str(c.n_pods) if c.n_pods > 1 else ''}")
        return {}
    if args.config not in CONFIGS:
        sys.exit(f"unknown config {args.config!r}; try --list-configs")
    if args.keep_best and not (args.eval_every and args.ckpt_dir):
        sys.exit("--keep-best requires --eval-every (the probe that "
                 "defines 'best') and --ckpt-dir (where best/ lives)")
    if args.eval_probe != "auto" and not args.eval_every:
        sys.exit("--eval-probe selects the --eval-every probe's regime; "
                 "without --eval-every no probe runs and the flag would "
                 "be a silent no-op")
    if args.ckpt_keep is not None:
        if args.ckpt_keep < 1:
            sys.exit("--ckpt-keep must be >= 1")
        if not args.ckpt_dir:
            sys.exit("--ckpt-keep requires --ckpt-dir (nothing is "
                     "retained without one)")
    if args.resume and not args.ckpt_dir:
        sys.exit("--resume requires --ckpt-dir")
    if args.faults is not None and args.faults not in FAULT_REGIMES:
        sys.exit(f"unknown --faults regime {args.faults!r}; known: "
                 f"{sorted(FAULT_REGIMES)}")
    if args.domains is not None and args.domains not in DOMAIN_REGIMES:
        sys.exit(f"unknown --domains regime {args.domains!r}; known: "
                 f"{sorted(DOMAIN_REGIMES)}")
    if not args.async_run:
        for flag, val, default in (("--actor-devices",
                                    args.actor_devices, None),
                                   ("--learner-devices",
                                    args.learner_devices, None),
                                   ("--staleness-bound",
                                    args.staleness_bound, 1),
                                   ("--queue-capacity",
                                    args.queue_capacity, 2)):
            if val != default:
                sys.exit(f"{flag} configures the async engine; pass "
                         f"--async with it (refusing the silent no-op)")
    else:
        if args.staleness_bound < 0:
            sys.exit("--staleness-bound must be >= 0")
        if args.queue_capacity < 1:
            sys.exit("--queue-capacity must be >= 1")
    if args.continual is None:
        for flag, val, default in (
                ("--continual-trust", args.continual_trust, 2.0),
                ("--continual-rho-max", args.continual_rho_max, 8.0)):
            if val != default:
                sys.exit(f"{flag} tunes the --continual ingest trust "
                         f"region; pass --continual LOGDIR with it "
                         f"(refusing the silent no-op)")
    else:
        if args.continual_trust < 1.0:
            sys.exit("--continual-trust must be >= 1.0 (the region is "
                     "[1/T, T])")
        if args.continual_rho_max <= 0:
            sys.exit("--continual-rho-max must be positive")
    if args.alarms and not args.obs_dir:
        sys.exit("--alarms requires --obs-dir (alarm events need an "
                 "event stream to land in)")
    if args.trace_spans and not args.obs_dir:
        sys.exit("--trace-spans requires --obs-dir (span events need an "
                 "event stream to land in)")
    if args.alarm_slow_iter is not None:
        if not args.alarms:
            sys.exit("--alarm-slow-iter is an alarm trigger; pass "
                     "--alarms (and --obs-dir) with it")
        if args.alarm_slow_iter <= 0:
            sys.exit("--alarm-slow-iter must be positive")
    if args.debug_nans and args.alarms:
        sys.exit(DEBUG_NANS_WITH_ALARMS)
    cfg = apply_overrides(CONFIGS[args.config], args)
    # the one mode-combination gate (modes that wait for a slice were
    # refused above, with their flags)
    if args.n_pop < 1:
        sys.exit("--n-pop must be >= 1")
    if args.pbt_ready < 1:
        sys.exit("--pbt-ready must be >= 1")
    try:
        validate_mode_combination({
            "async": args.async_run,
            "pbt": args.pbt,
            "faults": cfg.faults is not None,
            "domains": cfg.domains is not None,
            "fused_chunk": args.fused_chunk > 1,
            "hier": cfg.n_pods > 1,
            "vtrace": cfg.algo == "ppo" and cfg.ppo.correction == "vtrace",
            "sync": not args.async_run,
            # not the "vtrace" flag: continual forces the correction
            # against the measured serving lag, which the vtrace x sync
            # refusal (ratios == 1 on-policy) does not cover
            "continual": args.continual is not None,
        })
    except ModeCombinationError as e:
        sys.exit(str(e))
    if args.continual is not None and cfg.algo != "ppo":
        sys.exit("--continual retrains through the V-trace-corrected "
                 "PPO pipeline; the A2C update has no importance-"
                 "corrected variant")
    check_source_jobs(args, cfg)
    with contextlib.ExitStack() as stack:
        return _train(args, cfg, stack)


def _train(args, cfg: ExperimentConfig, stack: contextlib.ExitStack
           ) -> dict:
    """Build, (restore,) train and report; every context it opens (the
    telemetry first, so the checkpointer's events still land as the
    stack closes) goes on ``stack``."""
    from .obs import RunTelemetry
    from .utils import MetricsLogger, TensorBoardWriter, profiling
    dev = resolve_device(args.device)
    telemetry = bus = None
    if args.obs_dir:
        telemetry = stack.enter_context(RunTelemetry(
            os.path.abspath(args.obs_dir), rank=0, alarms=args.alarms,
            slow_iter_s=args.alarm_slow_iter, trace=args.trace_spans,
            device=dev))
        bus = telemetry.bus
    try:
        groups = None
        if args.async_run:
            # both roles share the experiment's device unless the flags
            # carve the groups: the split of two cards is unverified, so
            # it runs only when asked for (JAX splits whatever is visible)
            explicit = (args.actor_devices is not None
                        or args.learner_devices is not None)
            groups = split_devices(
                actor=args.actor_devices, learner=args.learner_devices,
                devices=dev if explicit else [home_device(dev)])
            groups.check_runnable()
            # the train state lives on the learner's device
            dev = groups.learner_device
        if args.pbt:
            exp = PopulationExperiment.build(
                cfg, n_pop=args.n_pop, device=dev,
                pbt_cfg=PBTConfig(ready_iters=args.pbt_ready, seed=cfg.seed))
        else:
            exp = Experiment.build(cfg, device=dev)
        ckpt = None
        if args.ckpt_dir:
            ckpt = Checkpointer(os.path.abspath(args.ckpt_dir),
                                max_to_keep=args.ckpt_keep or 3, bus=bus)
        if args.resume:
            meta = exp.restore_checkpoint(ckpt)
            # last_restored_step, not latest_step: the integrity fallback
            # may have restored an older retained step than the newest
            where = (f"{meta['pbt_events']} PBT rounds" if args.pbt
                     else f"window cursor {meta['window_cursor']}")
            print(f"resumed from step {ckpt.last_restored_step} "
                  f"(iteration {meta['iteration']}, {where})",
                  file=sys.stderr)
        if args.continual is not None:
            return _continual(args, exp, ckpt, telemetry)
        view = FittestMemberView(exp) if args.pbt else exp
        eval_kw = {}
        if args.eval_every:
            probe = make_eval_probe(cfg, view, args.eval_windows,
                                    args.eval_seed, args.eval_probe)
            if args.keep_best:
                probe = _keep_best(exp, ckpt, probe, bus)
            # --resume appends to the eval CSV as to the train one
            eval_csv = stack.enter_context(MetricsLogger(
                args.log_csv + ".eval.csv" if args.log_csv else None,
                append=args.resume))

            def eval_logger(i: int, m: dict) -> None:
                print(json.dumps({"iteration": i, **m}), flush=True)
                eval_csv(i, m)

            eval_kw = dict(eval_every=args.eval_every, eval_fn=probe,
                           eval_logger=eval_logger)
        if not args.pbt:
            exp.validate_fused_chunk(
                args.fused_chunk, args.iterations or cfg.iterations,
                log_every=args.log_every,
                ckpt_every=args.ckpt_every if ckpt is not None else 0,
                eval_every=args.eval_every)
    except (NotImplementedError, ValueError) as e:
        sys.exit(str(e))

    # --resume APPENDS to the metrics CSV (its header re-read and held
    # to this run's rows) instead of truncating the history
    csv_logger = stack.enter_context(
        MetricsLogger(args.log_csv, append=args.resume))
    tb = (stack.enter_context(TensorBoardWriter(args.tb_dir))
          if args.tb_dir else None)

    def logger(i: int, m: dict) -> None:
        print(json.dumps({"iteration": i, **m}), flush=True)
        csv_logger(i, m)
        if tb is not None:
            tb(i, m)

    if args.profile_dir:
        stack.enter_context(profiling.trace(args.profile_dir, dev))
    if args.debug_nans:
        stack.enter_context(profiling.debug_checks())
    run_kw = {} if telemetry is None else {"telemetry": telemetry}
    if args.async_run:
        print(f"async actor-learner: {groups.describe()} "
              f"staleness_bound={args.staleness_bound} "
              f"queue_capacity={args.queue_capacity}", file=sys.stderr)
        out = exp.run_async(
            groups=groups, staleness_bound=args.staleness_bound,
            queue_capacity=args.queue_capacity, log_every=args.log_every,
            logger=logger, ckpt=ckpt, ckpt_every=args.ckpt_every,
            **eval_kw, **run_kw)
    elif args.pbt:
        out = exp.run(log_every=args.log_every, logger=logger, ckpt=ckpt,
                      ckpt_every=args.ckpt_every, **eval_kw, **run_kw)
    else:
        out = exp.run(log_every=args.log_every, logger=logger, ckpt=ckpt,
                      ckpt_every=args.ckpt_every,
                      fused_chunk=args.fused_chunk, **eval_kw, **run_kw)
    dev = exp.device
    summary = {k: v for k, v in out.items() if k != "history"}
    summary.update(
        config=cfg.name, algo=cfg.algo, n_envs=cfg.n_envs,
        n_steps=algo_config(cfg).n_steps,
        device=str(dev),
        device_name=(torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else "cpu"))
    if args.pbt:
        summary.update(n_pop=args.n_pop, pbt_ready=args.pbt_ready,
                       fittest_member=exp.best_member())
    if args.report:
        report = eval_lib.jct_report(view)
        print(eval_lib.format_report(report), file=sys.stderr)
        summary["jct_report"] = numeric_rows(report)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
