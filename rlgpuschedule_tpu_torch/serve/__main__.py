"""Serving CLI of the port: ``python -m rlgpuschedule_tpu_torch.serve``.

Modes, composable in one invocation (at least one is required):

- ``--bench``: a deterministic request stream through the
  continuous-batching :class:`.batching.PolicyServer` over the
  :class:`.engine.InferenceEngine` (one CUDA graph per bucket on the
  card): p50/p99 decision latency, decisions/s, batch occupancy, and the
  steady-state contract, zero post-warmup recompiles across request
  sizes (``--request-sizes``, default three sizes inside ``--bucket``).
- ``--soak SECONDS``: paced load (``--rate``, default 200/s) through the
  live dispatcher threads, with ``--deadline-ms`` shedding,
  ``--adaptive-wait`` and, over ``--engines N``, ``--autoscale`` (the
  advisor resizes the router live) or ``--chaos-faults SPEC`` (engine
  faults injected mid-run, arrivals paced by the config's fitted trace,
  every request served, shed or failed: ``failed`` must be 0):
  first-half against second-half p99, shed rate.
- ``--scaleout``: decisions/s and shed rate, 1 engine against
  ``--engines`` routed engines on the same request stream.
- ``--host-path``: the data-plane bench, a zero-work stub engine
  isolating submit/coalesce/seal/scatter, legacy plane against arena
  plane, the arena's steady-state numpy allocations counted (must be 0);
  ``--wire-requests N`` adds the two socket arms through the front door
  (HTTP connection per request against framed keep-alive).
- ``--frontend-port PORT`` (with ``--soak``): the asyncio front door
  (:mod:`.frontend`, HTTP and framed) on PORT (0 = ephemeral) while the
  soak runs, SIGTERM draining it; after the soak a self-check: one real
  ``POST /v1/decide`` (200 with an action), a graceful drain, a late
  submit refused with the typed error, a new connection refused.
- ``--fleet N``: greedy replay against N seeded simulated clusters.
- ``--flight-log DIR`` (the data flywheel): with ``--soak``, every
  served decision is recorded into crc-sidecar'd shards under DIR
  (:mod:`..flywheel.flightlog`; the engine runs in capture mode, the
  same graph with the behavior log-prob and value as extra outputs) and
  the report's ``flight_log`` block checks ``rows_logged == served``;
  ``--durable-log`` fsyncs each shard and ledger line.
- ``--promote CKPTDIR`` and/or ``--promote-noise SIGMA`` (with
  ``--flight-log``): canary-gated promotion of a candidate (a port
  checkpoint, seeded noise on the served weights, or both): the logged
  window replayed under candidate and incumbent, the verdict in the
  ledger ``DIR/promotions.jsonl``, then, if the gate clears, a probe,
  the live swap with its blessed re-warm and the SLO watchdog, which
  rolls back on a breach (``--promote-fault`` injects one) and checks
  that the probe's decisions come back bit for bit.

``--engines N`` serves every mode but ``--fleet`` through the
:class:`.router.EngineRouter` (N engines, least-loaded dispatch, one
labeled sentinel series per engine). The engines take their devices
round-robin over the visible ones, so on one card they share it; the
reports say so.

The weights come from a checkpoint of the port's ``train``
(``--ckpt-dir``, at ``--ckpt-step`` or the newest step that restores),
from ``--weights x.npz`` (a Flax parameter tree of the JAX package saved
flat, see :func:`..models.convert.load_npz`; JAX's Orbax checkpoints do
not load here) or, by default, from a seeded initialization.
``--metrics-port`` exposes the live Prometheus scrape endpoint;
``--obs-dir`` writes the event stream
(``compile`` / ``recompile`` events, with ``--trace-spans`` the request
spans) and a ``metrics.prom`` snapshot. The device is ``cuda`` unless
``--device cpu`` is given; the JSON on stdout carries the ``repro``
block of the config.

``--fleet-regime`` replays every fleet cluster under a seeded fault
regime (flat configs; cluster ``e`` draws ``(--fleet-seed, e)``).

A hierarchical config
(``n_pods > 1``, config 5) is served through one engine (dict
observations, per-head actions); ``--engines > 1`` with it exits with
the mode table's refusal, in JAX's words. From a population's
checkpoint the fittest member is served.

Example::

    python -m rlgpuschedule_tpu_torch.serve --config ppo-cnn-philly512 \\
        --bench --bucket 256
    python -m rlgpuschedule_tpu_torch.serve --config ppo-mlp-synth64 \\
        --soak 4 --flight-log out/flog --durable-log
    python -m rlgpuschedule_tpu_torch.serve --config ppo-mlp-synth64 \\
        --flight-log out/flog --promote out/cont --promote-fault
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

from ..checkpoint import Checkpointer
from ..cli import add_config_flags, check_source_jobs, config_overrides
from ..configs import (CONFIGS, ModeCombinationError, repro_tuple,
                       validate_mode_combination)
from ..device import resolve_device
from ..experiment import build_env_params, build_policy, restore_policy
from ..models import load_npz
from ..obs import EventBus, Registry, Tracer, serve_http
from ..obs.trace import NULL_TRACER
from ..sim.faults import FAULT_REGIMES
from .batching import PolicyServer
from .bench import (build_request_pool, run_bench, run_chaos_soak,
                    run_host_path, run_scaleout, run_soak)
from .engine import InferenceEngine
from .fleet import fleet_replay, fleet_windows, sample_fleet_faults
from .router import (AutoscaleAdvisor, EngineRouter, ServeFaultInjector,
                     parse_serve_fault)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m rlgpuschedule_tpu_torch.serve",
        description="Greedy policy serving on the GPU: the "
                    "continuous-batching bench, soak, scale-out and "
                    "host-path bench over one engine or a router of "
                    "several, and fleet replay.")
    p.add_argument("--config", default="ppo-mlp-synth64",
                   choices=sorted(CONFIGS))
    p.add_argument("--seed", type=int, default=None,
                   help="trace and weight seed (default: the config's)")
    p.add_argument("--n-envs", type=int, default=None,
                   help="env windows the request pool is stepped on")
    add_config_flags(p)
    p.add_argument("--ckpt-dir", default=None,
                   help="serve the policy of this checkpoint dir (the "
                        "port's train --ckpt-dir; pick the step with "
                        "select_checkpoint)")
    p.add_argument("--ckpt-step", type=int, default=None,
                   help="the checkpoint step (default: the newest that "
                        "restores)")
    p.add_argument("--weights", default=None, metavar="NPZ",
                   help="Flax parameter tree saved flat as .npz")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    # bench
    p.add_argument("--bench", action="store_true",
                   help="latency bench through the continuous-batching "
                        "server; reports the post-warmup recompile count "
                        "(0 in a steady state)")
    p.add_argument("--bucket", type=int, default=8,
                   help="largest power-of-two batch bucket of the engine")
    p.add_argument("--rounds", type=int, default=24,
                   help="bench: coalesced dispatches to serve")
    p.add_argument("--request-sizes", default=None, metavar="A,B,...",
                   help="bench: request counts to cycle per round "
                        "(default: three sizes inside --bucket)")
    p.add_argument("--pool-steps", type=int, default=4,
                   help="env decision steps that build the request pool")
    p.add_argument("--soak", type=float, default=None, metavar="SECONDS",
                   help="paced load through the live dispatcher threads")
    p.add_argument("--rate", type=float, default=None, metavar="HZ",
                   help="soak arrival rate (default 200/s)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request latency SLO for --soak/--scaleout "
                        "submissions; requests that cannot meet it are "
                        "shed with a typed rejection")
    p.add_argument("--adaptive-wait", action="store_true",
                   help="learn the partial-bucket hold from the arrival "
                        "rate and the head-of-line deadline")
    p.add_argument("--host-path", action="store_true",
                   help="data-plane bench: stub engine, legacy against "
                        "arena plane, steady-state allocations (arena: 0)")
    p.add_argument("--host-rounds", type=int, default=300,
                   help="host-path: measured full-bucket rounds per arm")
    p.add_argument("--wire-requests", type=int, default=0, metavar="N",
                   help="host-path: also run the socket arms (HTTP "
                        "connection-per-request against framed "
                        "keep-alive) with N measured requests each; the "
                        "headline speedup becomes the wire ratio")
    p.add_argument("--frontend-port", type=int, default=None,
                   metavar="PORT",
                   help="with --soak: run the asyncio front door on this "
                        "port (0 = ephemeral) and self-check the wire "
                        "contract after the soak (200 decide, graceful "
                        "drain, typed late-submit refusal)")
    p.add_argument("--fleet", type=int, default=None, metavar="N",
                   help="replay the policy against N seeded clusters")
    p.add_argument("--fleet-regime", default=None, metavar="REGIME",
                   help="with --fleet: replay every cluster under this "
                        "seeded fault regime (sim.faults.FAULT_REGIMES; "
                        "flat configs)")
    p.add_argument("--fleet-seed", type=int, default=0,
                   help="with --fleet-regime: base seed of the fault "
                        "draws (cluster e draws (seed, e))")
    p.add_argument("--max-steps", type=int, default=None,
                   help="fleet: cap decision steps per cluster (default: "
                        "the config's horizon)")
    # observability
    p.add_argument("--metrics-port", type=int, default=None,
                   help="live Prometheus scrape endpoint on this port (0 "
                        "= ephemeral; the port and a self-scrape check "
                        "land in the JSON)")
    p.add_argument("--obs-dir", default=None,
                   help="write serve events (JSONL) and a metrics.prom "
                        "snapshot under this directory")
    p.add_argument("--trace-spans", action="store_true",
                   help="record the request lifecycle as spans on the "
                        "event bus (needs --obs-dir)")
    # the router
    p.add_argument("--engines", type=int, default=1,
                   help="serve through N routed engines (round-robin over "
                        "the visible devices: N engines share one card; "
                        "least-loaded dispatch; N=1 keeps the single "
                        "engine). Refused for hierarchical configs")
    p.add_argument("--scaleout", action="store_true",
                   help="decisions/s + shed rate vs engine count: "
                        "isolated 1-engine and --engines-engine arms "
                        "serving the same stream")
    p.add_argument("--autoscale", action="store_true",
                   help="with --soak: run the AutoscaleAdvisor loop (SLO "
                        "gauges -> desired engine count, applied live by "
                        "the router with hysteresis)")
    p.add_argument("--chaos-faults", default=None,
                   metavar="SPEC[,SPEC...]",
                   help="with --soak: inject engine faults mid-run "
                        "(kind@N[:engine=E], kind in engine-raise / "
                        "engine-hang / engine-slow; N = router dispatch "
                        "sequence, fires on the target engine's first "
                        "dispatch >= N). The soak paces arrivals by the "
                        "config's fitted trace arrival process and "
                        "reports request conservation; needs "
                        "--engines >= 2")
    # the data flywheel: flight log and canary-gated promotion
    p.add_argument("--flight-log", default=None, metavar="DIR",
                   help="with --soak: record every served decision (obs, "
                        "mask, action, behavior log-prob, value, stall, "
                        "deadline outcome, request id) into crc-sidecar'd "
                        "shards under DIR; with --promote*: the logged "
                        "window the canary replays. Switches the engine "
                        "to capture mode (the same graph, two more "
                        "outputs)")
    p.add_argument("--flight-capacity", type=int, default=512,
                   help="flight log rows per sealed shard")
    p.add_argument("--durable-log", action="store_true",
                   help="fsync flight-log shards and promotion-ledger "
                        "lines (power-loss durability; the default "
                        "flushes only)")
    p.add_argument("--promote", default=None, metavar="CKPTDIR",
                   help="canary-gated promotion: the candidate policy of "
                        "this checkpoint dir (the port's train "
                        "--ckpt-dir, e.g. a --continual retrain) replays "
                        "the --flight-log window beside the incumbent; "
                        "the serving weights swap only if the hysteresis "
                        "gate clears, and the post-swap SLO watchdog "
                        "rolls back on a regression")
    p.add_argument("--promote-step", type=int, default=None,
                   help="candidate checkpoint step (default: the newest "
                        "that restores)")
    p.add_argument("--promote-noise", type=float, default=None,
                   metavar="SIGMA",
                   help="perturb the candidate with seeded N(0, SIGMA) "
                        "noise (alone: noise on the served weights; with "
                        "--promote: on the loaded candidate); a large "
                        "SIGMA is the regressed candidate the gate must "
                        "block")
    p.add_argument("--promote-fault", action="store_true",
                   help="inject a post-swap SLO regression (the "
                        "watchdog's observed p99 inflated 10x) to prove "
                        "that the rollback restores the incumbent bit "
                        "for bit")
    p.add_argument("--canary-slices", type=int, default=8,
                   help="held-out window slices the hysteresis gate "
                        "scores")
    p.add_argument("--canary-tol", type=float, default=0.02,
                   help="per-slice agreement regression tolerance")
    p.add_argument("--canary-hysteresis", type=int, default=2,
                   help="consecutive regressed slices that block "
                        "promotion")
    return p


def _check(args) -> "tuple[tuple[int, ...] | None, list | None]":
    """Refuse the silent no-ops (the router's and the flywheel's checks
    are JAX's, word for word); returns the parsed ``--request-sizes``
    and ``--chaos-faults``."""
    if args.weights and args.ckpt_dir:
        sys.exit("--weights and --ckpt-dir both name the served weights; "
                 "pass one")
    if args.ckpt_step is not None and not args.ckpt_dir:
        sys.exit("--ckpt-step picks a step of --ckpt-dir; pass --ckpt-dir "
                 "with it")
    promote_mode = (args.promote is not None
                    or args.promote_noise is not None)
    if not (args.bench or args.soak is not None or args.scaleout
            or args.host_path or args.fleet is not None or promote_mode):
        sys.exit("nothing to do: pass --bench, --soak S, --scaleout, "
                 "--host-path, --promote/--promote-noise, and/or "
                 "--fleet N")
    if args.fleet is not None and args.fleet <= 0:
        sys.exit("--fleet must be a positive cluster count")
    if args.fleet_regime is not None and args.fleet_regime not in \
            FAULT_REGIMES:
        sys.exit(f"unknown --fleet-regime {args.fleet_regime!r}; "
                 f"known: {sorted(FAULT_REGIMES)}")
    if args.max_steps is not None and args.max_steps <= 0:
        sys.exit("--max-steps must be positive")
    if args.bucket <= 0 or (args.bucket & (args.bucket - 1)):
        sys.exit("--bucket must be a positive power of two")
    if args.engines < 1:
        sys.exit("--engines must be >= 1")
    if args.scaleout and args.engines < 2:
        sys.exit("--scaleout compares 1 engine vs --engines; pass "
                 "--engines >= 2 with it")
    if args.soak is not None and args.soak <= 0:
        sys.exit("--soak must be a positive duration in seconds")
    if args.rate is not None and args.soak is None:
        sys.exit("--rate paces --soak submissions; pass --soak S with it "
                 "(refusing the silent no-op)")
    if args.rate is not None and args.rate <= 0:
        sys.exit("--rate must be positive requests/s")
    if args.autoscale and args.soak is None:
        sys.exit("--autoscale runs the advisor loop during --soak; "
                 "pass --soak S with it (refusing the silent no-op)")
    if args.autoscale and args.engines < 2:
        sys.exit("--autoscale resizes a multi-engine router; pass "
                 "--engines >= 2 with it (one engine cannot scale)")
    chaos_specs = None
    if args.chaos_faults is not None:
        if args.soak is None:
            sys.exit("--chaos-faults injects engine faults during "
                     "--soak; pass --soak S with it (refusing the "
                     "silent no-op)")
        if args.engines < 2:
            sys.exit("--chaos-faults needs --engines >= 2: the retry "
                     "hedge moves a failed dispatch to a DIFFERENT "
                     "healthy engine (one engine has nowhere to go)")
        if args.autoscale:
            sys.exit("--chaos-faults runs the chaos soak, which does "
                     "not drive the autoscale loop; drop --autoscale "
                     "(refusing the silent no-op)")
        try:
            chaos_specs = [parse_serve_fault(s)
                           for s in args.chaos_faults.split(",") if s]
        except ValueError as e:
            sys.exit(str(e))
        if not chaos_specs:
            sys.exit("--chaos-faults got no specs")
        bad_engine = [s for s in chaos_specs
                      if not 0 <= s.engine < args.engines]
        if bad_engine:
            sys.exit(f"--chaos-faults targets engine(s) "
                     f"{sorted({s.engine for s in bad_engine})} outside "
                     f"[0, {args.engines})")
    if args.deadline_ms is not None and args.deadline_ms <= 0:
        sys.exit("--deadline-ms must be positive")
    if (args.deadline_ms is not None and args.soak is None
            and not args.scaleout):
        sys.exit("--deadline-ms attaches SLOs to --soak/--scaleout "
                 "submissions; pass one of them (refusing the silent "
                 "no-op)")
    if args.host_rounds <= 0:
        sys.exit("--host-rounds must be positive")
    if args.wire_requests < 0:
        sys.exit("--wire-requests must be >= 0")
    if args.wire_requests and not args.host_path:
        sys.exit("--wire-requests adds socket arms to --host-path; pass "
                 "--host-path with it (refusing the silent no-op)")
    if args.frontend_port is not None and args.soak is None:
        sys.exit("--frontend-port runs the HTTP front door around --soak; "
                 "pass --soak S with it (refusing the silent no-op)")
    if args.frontend_port is not None and args.frontend_port < 0:
        sys.exit("--frontend-port must be >= 0 (0 = ephemeral)")
    if args.pool_steps < 0:
        sys.exit("--pool-steps must be >= 0")
    if args.trace_spans and not args.obs_dir:
        sys.exit("--trace-spans records spans on the event bus; pass "
                 "--obs-dir with it (refusing the silent no-op)")
    if args.flight_log is not None and args.soak is None \
            and not promote_mode:
        sys.exit("--flight-log records --soak traffic or feeds "
                 "--promote replay; pass one of them (refusing the "
                 "silent no-op)")
    if promote_mode and args.flight_log is None:
        sys.exit("promotion replays a logged window; pass "
                 "--flight-log DIR with --promote/--promote-noise")
    if args.flight_capacity <= 0:
        sys.exit("--flight-capacity must be a positive row count")
    if args.promote_step is not None and args.promote is None:
        sys.exit("--promote-step picks the --promote candidate step; "
                 "pass --promote CKPTDIR with it (refusing the silent "
                 "no-op)")
    if args.promote_noise is not None and args.promote_noise <= 0:
        sys.exit("--promote-noise must be a positive sigma")
    if args.promote_fault and not promote_mode:
        sys.exit("--promote-fault injects a post-swap SLO regression; "
                 "pass --promote/--promote-noise with it (refusing "
                 "the silent no-op)")
    if args.canary_slices < 1:
        sys.exit("--canary-slices must be >= 1")
    if args.canary_tol < 0:
        sys.exit("--canary-tol must be >= 0")
    if args.canary_hysteresis < 1:
        sys.exit("--canary-hysteresis must be >= 1")
    if args.durable_log and args.flight_log is None:
        sys.exit("--durable-log hardens the --flight-log shards and "
                 "ledger; pass --flight-log DIR with it (refusing the "
                 "silent no-op)")
    if args.request_sizes is None:
        return None, chaos_specs
    if not args.bench:
        sys.exit("--request-sizes configures --bench (refusing the silent "
                 "no-op)")
    try:
        sizes = tuple(int(s) for s in args.request_sizes.split(",") if s)
    except ValueError:
        sys.exit(f"bad --request-sizes {args.request_sizes!r}")
    if not sizes or any(s <= 0 for s in sizes):
        sys.exit("--request-sizes must be positive integers")
    too_big = [s for s in sizes if s > args.bucket]
    if too_big:
        sys.exit(f"--request-sizes {too_big} exceed --bucket {args.bucket}")
    return sizes, chaos_specs


def main(argv: "list[str] | None" = None) -> dict:
    args = build_parser().parse_args(argv)
    sizes, chaos_specs = _check(args)
    cfg = dataclasses.replace(CONFIGS[args.config], **config_overrides(args))
    try:
        validate_mode_combination({"router": args.engines > 1,
                                   "hier": cfg.n_pods > 1})
    except ModeCombinationError as e:
        sys.exit(str(e))
    if cfg.n_pods > 1 and (args.frontend_port is not None
                           or args.wire_requests):
        sys.exit("--frontend-port and --wire-requests serve one-array rows; "
                 "a hierarchical config's dict requests are served in "
                 "process only (--bench, --soak)")
    check_source_jobs(args, cfg)
    dev = resolve_device(args.device)
    env_params = build_env_params(cfg)
    policy = build_policy(cfg, env_params, device=dev)
    repro = repro_tuple(cfg, ckpt_dir=args.ckpt_dir)
    promote_mode = (args.promote is not None
                    or args.promote_noise is not None)
    if args.ckpt_dir:
        with Checkpointer(os.path.abspath(args.ckpt_dir)) as ckpt:
            meta = restore_policy(ckpt, policy, args.ckpt_step)
        if "member" in meta:
            repro["member"] = meta["member"]
        # resolved, not requested: the integrity fallback may restore an
        # older retained step than asked for
        repro["ckpt_step"] = ckpt.last_restored_step
        print(f"policy restored from {args.ckpt_dir} (step "
              f"{repro['ckpt_step']})", file=sys.stderr)
    elif args.weights:
        policy.load_state_dict(load_npz(args.weights))
        print(f"policy weights from {args.weights}", file=sys.stderr)
    else:
        print(f"note: no --ckpt-dir or --weights; serving seeded init "
              f"weights (seed {cfg.seed})", file=sys.stderr)
    report: dict = {"config": cfg.name, "seed": cfg.seed,
                    "weights": args.weights, "repro": repro,
                    "device": str(dev)}
    if dev.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(dev)
    registry = Registry()
    bus = (EventBus(os.path.abspath(args.obs_dir), rank=0, name="serve")
           if args.obs_dir else None)
    tracer = Tracer(bus, enabled=True) if args.trace_spans else NULL_TRACER
    scraper = None
    try:
        if args.metrics_port is not None:
            scraper = serve_http(registry, port=args.metrics_port)
            print(f"metrics scrape endpoint: {scraper.url}",
                  file=sys.stderr)
        injector = (ServeFaultInjector(chaos_specs, bus=bus)
                    if chaos_specs is not None else None)
        # recording and the canary's probe need the engine's capture
        # outputs (the behavior log-prob and value from the same graph)
        capture = args.flight_log is not None
        if args.engines > 1:
            engine = EngineRouter(policy, env_params, max_bucket=args.bucket,
                                  registry=registry, bus=bus, tracer=tracer,
                                  n_engines=args.engines, device=dev,
                                  fault_injector=injector, capture=capture)
            print(f"engine router: {args.engines} engines on "
                  f"{[str(e.device) for e in engine.engines]}"
                  + (" (CPU: dispatch serialized)"
                     if engine.serialized_dispatch() else ""),
                  file=sys.stderr)
        else:
            engine = InferenceEngine(policy, max_bucket=args.bucket,
                                     device=dev, env_params=env_params,
                                     registry=registry, bus=bus,
                                     tracer=tracer, capture=capture)
        pool = None
        if (args.bench or args.soak is not None or args.scaleout
                or args.host_path or promote_mode):
            _, traces = fleet_windows(cfg, cfg.n_envs, device=dev)
            pool = build_request_pool(policy, env_params, traces,
                                      steps=args.pool_steps)
        if args.bench:
            server = PolicyServer(engine, registry=registry, tracer=tracer,
                                  bus=bus, adaptive_wait=args.adaptive_wait)
            b = report["bench"] = run_bench(engine, server, pool,
                                            rounds=args.rounds,
                                            request_sizes=sizes)
            print(f"bench: {b['requests']} decisions over {b['rounds']} "
                  f"dispatches (sizes {b['request_sizes']} -> buckets "
                  f"{b['buckets']}, graphs {b['graphs']}), p50 "
                  f"{b['latency_p50_ms']:.2f} ms, p99 "
                  f"{b['latency_p99_ms']:.2f} ms, "
                  f"{b['decisions_per_s']:.0f} decisions/s, post-warmup "
                  f"recompiles: {b['post_warmup_recompiles']}",
                  file=sys.stderr)
        # the behavior policy's train step: the served checkpoint's, or
        # 0 for seeded or converted weights
        policy_step = int(repro.get("ckpt_step") or 0)
        if args.soak is not None:
            writer = None
            if args.flight_log is not None:
                from ..flywheel import FlightLogWriter
                writer = FlightLogWriter(
                    os.path.abspath(args.flight_log),
                    capacity=args.flight_capacity, policy_step=policy_step,
                    registry=registry, bus=bus, durable=args.durable_log)
            report["soak"], frontend = _soak(args, cfg, engine, pool,
                                             registry, tracer, bus,
                                             chaos_specs, writer)
            if frontend is not None:
                report["frontend"] = frontend
            if writer is not None:
                report["flight_log"] = _seal_flight_log(
                    args, writer, report["soak"], frontend)
        if promote_mode:
            report["promote"] = _run_promotion(
                args, cfg, policy, env_params, engine, pool, registry, bus,
                warmed=args.soak is not None, incumbent_step=policy_step)
        if args.scaleout:
            so = report["scaleout"] = run_scaleout(
                policy, env_params, pool, max_bucket=args.bucket,
                rounds=args.rounds, request_sizes=sizes,
                engine_counts=(1, args.engines),
                deadline_s=(args.deadline_ms / 1e3
                            if args.deadline_ms is not None else None),
                device=dev)
            for arm in so["arms"]:
                print(f"scaleout[{arm['engines']} engine(s)]: "
                      f"{arm['decisions_per_s']:.0f} decisions/s, shed "
                      f"{arm['shed_rate']:.1%}, rows/engine "
                      f"{arm['per_engine_rows']}, recompiles "
                      f"{arm['per_engine_recompiles']}", file=sys.stderr)
            if so["caveat"]:
                print(f"scaleout caveat: {so['caveat']}", file=sys.stderr)
        if args.host_path:
            hp = report["host_path"] = run_host_path(
                pool, max_bucket=args.bucket, rounds=args.host_rounds,
                wire_requests=args.wire_requests)
            for arm in hp["arms"]:
                print(f"host-path[{arm['data_plane']}]: "
                      f"{arm['decisions_per_s']:.0f} decisions/s, "
                      f"{arm['alloc_calls']} ndarray allocs "
                      f"({arm['allocs_per_batch']:.1f}/batch), "
                      f"conservation "
                      + ("ok" if arm["conservation_ok"] else "VIOLATED"),
                      file=sys.stderr)
            for arm in hp.get("wire_arms", ()):
                print(f"host-path[{arm['transport']}]: "
                      f"{arm['decisions_per_s']:.0f} decisions/s over "
                      f"{arm['clients']} clients, conservation "
                      + ("ok" if arm["conservation_ok"] else "VIOLATED"),
                      file=sys.stderr)
            line = f"host-path speedup: {hp['speedup']:.2f}x"
            if "wire_arms" in hp:
                line += f" (wire; in-process {hp['speedup_inproc']:.2f}x)"
            print(line, file=sys.stderr)
        if args.fleet is not None:
            windows, traces = fleet_windows(cfg, args.fleet, device=dev)
            faults = (sample_fleet_faults(cfg.n_nodes, args.fleet_regime,
                                          args.fleet_seed, args.fleet,
                                          windows, dev)
                      if args.fleet_regime is not None else None)
            fl = report["fleet"] = fleet_replay(
                policy, env_params, traces, max_steps=args.max_steps,
                device=dev, faults=faults)
            fl["regime"] = args.fleet_regime
            fl["fleet_seed"] = (args.fleet_seed if args.fleet_regime
                                else None)
            registry.gauge("serve_fleet_mean_jct",
                           "fleet replay pooled mean JCT").set(
                fl["mean_jct"])
            registry.gauge("serve_fleet_completion",
                           "fleet replay completed fraction").set(
                fl["completion"])
            registry.gauge("serve_fleet_decisions_per_s",
                           "fleet replay decision throughput").set(
                fl["decisions_per_s"])
            print(f"fleet: {fl['n_clusters']} clusters on {dev}"
                  + (f" under {args.fleet_regime!r} faults"
                     if args.fleet_regime else "") + ", mean JCT "
                  f"{fl['mean_jct']:.1f} s, completion "
                  f"{fl['completion']:.1%}, {fl['decisions']} decisions in "
                  f"{fl['wall_s']:.2f} s ({fl['decisions_per_s']:.0f}/s)",
                  file=sys.stderr)
        if scraper is not None:
            report["scrape"] = _self_scrape(scraper)
        if args.obs_dir:
            registry.write(os.path.join(os.path.abspath(args.obs_dir),
                                        "metrics.prom"))
    finally:
        if scraper is not None:
            scraper.close()
        if bus is not None:
            bus.close()
    print(json.dumps(report))
    return report


def _soak(args, cfg, engine, pool, registry, tracer, bus,
          chaos_specs, flight_log=None) -> "tuple[dict, dict | None]":
    """``--soak``: every bucket of every engine warmed, then paced load
    through one dispatcher thread per engine (the autoscale loop or the
    chaos soak over a router), with ``--frontend-port`` the front door
    open meanwhile and ``flight_log`` (a writer) recording every served
    row; returns the soak's report and the front door's self-check
    (None without it)."""
    from ..traces.fit import domain_fit
    obs0, mask0 = pool[0]
    engine.warmup(obs0, mask0)
    server = PolicyServer(engine, registry=registry, tracer=tracer,
                          bus=bus, adaptive_wait=args.adaptive_wait,
                          flight_log=flight_log)
    router = engine if args.engines > 1 else None
    advisor = (AutoscaleAdvisor(registry, n_max=args.engines,
                                initial=args.engines)
               if args.autoscale else None)
    deadline_s = (args.deadline_ms / 1e3 if args.deadline_ms is not None
                  else None)
    server.start(dispatchers=args.engines)
    fe_handle = None
    frontend = None
    try:
        if args.frontend_port is not None:
            from .frontend import start_frontend
            fe_handle = start_frontend(server, obs0, mask0,
                                       port=args.frontend_port)
            fe_handle.install_sigterm()
            print(f"http front door: {fe_handle.url} (SIGTERM drains "
                  f"gracefully)", file=sys.stderr)
        if chaos_specs is not None:
            soak = run_chaos_soak(
                server, pool, fit=domain_fit(cfg), duration_s=args.soak,
                rate_hz=args.rate if args.rate is not None else 150.0,
                deadline_s=deadline_s, router=router, seed=cfg.seed)
        else:
            soak = run_soak(server, pool, duration_s=args.soak,
                            rate_hz=args.rate if args.rate is not None
                            else 200.0,
                            deadline_s=deadline_s, router=router,
                            advisor=advisor)
        if fe_handle is not None:
            frontend = _frontend_selfcheck(fe_handle, obs0, mask0)
    finally:
        if fe_handle is not None:
            fe_handle.close()       # the drain also closes the server
        else:
            server.stop()
    if frontend is not None:
        print(f"front door: decide {frontend['decide_status']}, late "
              f"submit {frontend['late_submit']}, post-drain connect "
              f"{frontend['post_drain_connect']}", file=sys.stderr)
    soak["post_warmup_recompiles"] = engine.post_warmup_recompiles
    soak["dispatch_errors"] = int(
        registry.counter("serve_dispatch_errors_total").value)
    drift = soak["p99_drift"]
    print(f"soak: {soak['requests']} requests over "
          f"{soak['duration_s']:.1f}s at {soak['rate_hz']:.0f}/s, shed "
          f"{soak['shed']} ({soak['shed_rate']:.1%}), p99 "
          f"{soak['p99_first_half_ms']} -> {soak['p99_second_half_ms']} ms "
          f"(drift " + (f"{drift:.2f}x" if drift is not None else "n/a")
          + f"), post-warmup recompiles: {soak['post_warmup_recompiles']}",
          file=sys.stderr)
    if chaos_specs is not None:
        fs = soak["fault_stats"]
        fired = sum(s.fired for s in chaos_specs)
        soak["chaos_faults"] = args.chaos_faults
        soak["faults_fired"] = int(fired)
        conserved = soak["conservation_ok"] and soak["failed"] == 0
        print(f"chaos: {fired}/{len(chaos_specs)} faults fired, engine "
              f"failures {fs['failures']}, ejections {fs['ejections']}, "
              f"readmissions {fs['readmissions']}, retry hedges "
              f"{fs['retry_hedges']}, conservation "
              + ("ok" if conserved else "VIOLATED"), file=sys.stderr)
    return soak, frontend


def _seal_flight_log(args, writer, soak: dict, frontend) -> dict:
    """Seal the soak's flight log and check conservation: every served
    row was logged and nothing else (the front door's self-check served
    one more request through the same server)."""
    writer.close()
    served = soak["served"] + (1 if frontend is not None
                               and frontend["decide_status"] == 200 else 0)
    fl = {"dir": os.path.abspath(args.flight_log),
          "rows_logged": writer.rows_logged,
          "shards_sealed": writer.shards_sealed, "served": served,
          "durable": bool(args.durable_log),
          "conservation_ok": writer.rows_logged == served}
    print(f"flight log: {fl['rows_logged']} rows in {fl['shards_sealed']} "
          f"shards under {fl['dir']}, conservation "
          + ("ok" if fl["conservation_ok"] else "VIOLATED"),
          file=sys.stderr)
    return fl


def _swap_weights(engine, state_dict) -> "tuple[int, ...]":
    """Live swap and blessed re-warm through whichever serving surface is
    up: the router swaps every engine; a lone engine swaps in place.
    Both re-drive the warmed buckets, so a drift shows here as a
    recompile alarm, not on live traffic."""
    if hasattr(engine, "swap_params"):
        return engine.swap_params(state_dict)
    engine.set_params(state_dict)
    return engine.rewarm()


def _run_promotion(args, cfg, policy, env_params, engine, pool, registry,
                   bus, warmed: bool, incumbent_step: int) -> dict:
    """``serve --promote``: canary-gate the candidate on the logged
    window, swap only if the gate clears, then watch the post-swap SLOs
    and roll back on a regression.

    The candidate is the policy of ``--promote CKPTDIR`` and/or the
    served weights with seeded ``--promote-noise`` (``default_rng(seed)``
    normal noise, tensor by tensor in the state dict's order, which is
    not JAX's leaf order: the same seed gives another candidate than
    JAX's). ``--promote-fault`` inflates the watchdog's observed p99 10x
    after the swap; the rollback itself is real, and the probe must
    give the pre-promotion decisions back bit for bit.
    ``probe_rows_changed`` counts the probe rows that the swapped-in
    candidate decided otherwise, so a rollback is known to have
    restored something."""
    import time

    import numpy as np

    from ..experiment import build_policy, restore_policy
    from ..flywheel import (PromotionLedger, SLOWatchdog, read_flight_log,
                            run_canary, unflatten_like)
    from ..tree import leaves

    flight_dir = os.path.abspath(args.flight_log)
    data = (read_flight_log(flight_dir) if os.path.isdir(flight_dir)
            else None)
    if data is None or not data.shards:
        sys.exit(f"--promote: no verified flight-log shards under "
                 f"{flight_dir}"
                 + (f" (torn tail: {data.torn_reason})"
                    if data is not None and data.torn_tail else ""))
    window = data.concat()
    obs0, mask0 = pool[0]
    # the served weights, copied: a lone engine's swap writes into them
    incumbent = {k: v.detach().clone()
                 for k, v in policy.state_dict().items()}
    candidate = incumbent
    source = "incumbent"
    if args.promote is not None:
        cand = build_policy(cfg, env_params, device=next(
            policy.parameters()).device)
        with Checkpointer(os.path.abspath(args.promote)) as cckpt:
            restore_policy(cckpt, cand, args.promote_step)
            source = (f"{os.path.abspath(args.promote)}"
                      f"@{cckpt.last_restored_step}")
        candidate = cand.state_dict()
    if args.promote_noise is not None:
        rng = np.random.default_rng(cfg.seed)
        candidate = {
            k: (v + torch.from_numpy(rng.normal(
                0.0, args.promote_noise, tuple(v.shape)).astype(np.float32)
                ).to(v.device, v.dtype))
            if v.is_floating_point() else v
            for k, v in candidate.items()}
        source += f"+noise(sigma={args.promote_noise:g},seed={cfg.seed})"

    rep = run_canary(policy, incumbent, candidate, window, obs0, mask0,
                     env_params=env_params, slices=args.canary_slices,
                     tol=args.canary_tol, hysteresis=args.canary_hysteresis,
                     registry=registry, bus=bus)
    ledger = PromotionLedger(flight_dir, durable=args.durable_log)
    lineage = {"candidate": source, "incumbent_step": int(incumbent_step),
               "window_rows": window.rows, "verdict": rep.verdict,
               "incumbent_agreement": rep.incumbent_agreement,
               "candidate_agreement": rep.candidate_agreement}
    out = {"candidate": source, "verdict": rep.verdict,
           "canary": rep.to_json(), "promoted": False,
           "rollback": False, "ledger_entries": 1}
    if rep.verdict != "promote":
        ledger.append(dict(lineage, action="blocked",
                           regress_streak=rep.max_regress_streak))
        print(f"promotion BLOCKED: candidate agreement "
              f"{rep.candidate_agreement:.3f} vs incumbent "
              f"{rep.incumbent_agreement:.3f} on the logged window "
              f"(regressed streak {rep.max_regress_streak} >= "
              f"{args.canary_hysteresis})", file=sys.stderr)
        return out

    # the gate cleared: the pre-promotion probe, the swap, the watchdog
    if not warmed:
        engine.warmup(obs0, mask0)
    k = min(args.bucket, window.rows)
    probe_obs = unflatten_like(obs0, [l[:k] for l in window.obs_leaves])
    probe_mask = unflatten_like(mask0, [l[:k] for l in window.mask_leaves])
    probe_stall = window.stall[:k]

    def probe() -> "tuple[list, float]":
        t0 = time.perf_counter()
        (acts, _, _), _ = engine.decide(probe_obs, probe_mask, probe_stall)
        return ([np.asarray(a) for a in leaves(acts)],
                (time.perf_counter() - t0) * 1e3)

    g_p99 = registry.gauge("serve_decision_latency_p99_ms")
    wd = SLOWatchdog(registry, engine=engine, breach_after=2, bus=bus)
    pre_acts: list = []
    for _ in range(4):
        pre_acts, ms = probe()
        g_p99.set(ms)
        wd.sample_baseline()
    recomp_before = int(engine.post_warmup_recompiles)
    driven = _swap_weights(engine, candidate)
    wd.arm()
    swap_recompiles = int(engine.post_warmup_recompiles) - recomp_before
    if bus is not None:
        bus.emit("promote_apply", candidate=source,
                 rewarmed_buckets=list(driven),
                 swap_recompiles=swap_recompiles)
    ledger.append(dict(lineage, action="promote",
                       rewarmed_buckets=list(driven),
                       swap_recompiles=swap_recompiles))
    out.update(promoted=True, rewarmed_buckets=list(driven),
               swap_recompiles=swap_recompiles, ledger_entries=2)
    print(f"promoted {source}: canary agreement "
          f"{rep.candidate_agreement:.3f}, re-warmed buckets "
          f"{tuple(driven)}, swap recompiles {swap_recompiles}",
          file=sys.stderr)

    ticks, breach, changed = [], None, 0
    for _ in range(max(3, args.canary_hysteresis + 1)):
        acts, ms = probe()
        # probe rows the candidate decides otherwise: the graphs read
        # the swapped weights (0 when the candidate agrees on them)
        changed = max(changed, sum(int((a != b).sum())
                                   for a, b in zip(acts, pre_acts)))
        if args.promote_fault:
            ms *= 10.0        # the injected post-swap SLO regression
        g_p99.set(ms)
        tick = wd.observe()
        ticks.append({k_: tick[k_] for k_ in
                      ("rollback", "reasons", "streak", "p99_ms",
                       "baseline_p99_ms")})
        if tick["rollback"]:
            breach = tick
            break
    out.update(watchdog_ticks=ticks, probe_rows_changed=changed)
    if breach is not None:
        _swap_weights(engine, incumbent)
        post_acts, _ = probe()
        bit = (len(pre_acts) == len(post_acts)
               and all(np.array_equal(a, b)
                       for a, b in zip(pre_acts, post_acts)))
        ledger.append(dict(lineage, action="rollback",
                           reasons=breach["reasons"],
                           bit_identical=bool(bit)))
        out.update(rollback=True, rollback_reasons=breach["reasons"],
                   probe_bit_identical=bool(bit), ledger_entries=3)
        print(f"ROLLBACK: {breach['reasons']}; incumbent restored, "
              f"probe decisions bit-identical: {bit}", file=sys.stderr)
    out["post_warmup_recompiles"] = int(engine.post_warmup_recompiles)
    return out


def _frontend_selfcheck(handle, obs0, mask0) -> dict:
    """The wire contract on the live front door: one real POST decide
    answers 200 with an action (no deadline attached, so a loaded server
    still serves), then a graceful drain, after which a late submit gets
    the typed :class:`.batching.ServerClosedError` and a new connection
    is refused."""
    import urllib.error
    import urllib.request

    import numpy as np

    from .batching import ServerClosedError

    body = (np.ascontiguousarray(obs0).tobytes()
            + np.ascontiguousarray(mask0).tobytes())
    req = urllib.request.Request(handle.url + "/v1/decide", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        decide_status = resp.status
        payload = json.loads(resp.read().decode())
    handle.drain()
    try:
        handle.frontend.server.submit(obs0, mask0)
        late_submit = "accepted"          # a contract violation
    except ServerClosedError:
        late_submit = "server-closed"
    try:
        urllib.request.urlopen(
            urllib.request.Request(handle.url + "/v1/decide", data=body,
                                   method="POST"), timeout=5)
        post_drain_connect = "accepted"   # a contract violation
    except (urllib.error.URLError, ConnectionError):
        post_drain_connect = "refused"
    return {"url": handle.url, "port": handle.port,
            "decide_status": decide_status,
            "decide_has_action": "action" in payload,
            "request_id": payload.get("request_id"),
            "drained": True, "late_submit": late_submit,
            "post_drain_connect": post_drain_connect}


def _self_scrape(scraper) -> dict:
    """GET the live endpoint once and check that the exposition is well
    formed."""
    import urllib.request
    with urllib.request.urlopen(scraper.url, timeout=10) as resp:
        body = resp.read().decode("utf-8")
        status = resp.status
        ctype = resp.headers.get("Content-Type", "")
    lines = [ln for ln in body.splitlines() if ln]
    sample_lines = [ln for ln in lines if not ln.startswith("#")]
    well_formed = (
        status == 200 and ctype.startswith("text/plain")
        and all(ln.startswith(("# HELP ", "# TYPE "))
                or len(ln.split()) == 2 for ln in lines)
        and any(ln.startswith("serve_") for ln in sample_lines))
    return {"url": scraper.url, "port": scraper.port, "status": status,
            "content_type": ctype, "metric_lines": len(sample_lines),
            "well_formed": bool(well_formed)}


if __name__ == "__main__":
    main()
