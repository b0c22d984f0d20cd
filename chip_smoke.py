#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and evaluation paths
on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card. It
imports nothing of JAX. A CLI named below runs through its ``main`` in
this process, under torch's default cuDNN/TF32 switches, as ``python -m``
would run it without a new interpreter's start; phase 18's bench and
phase 24's train, evaluate and bench runs are processes of their own.
Phases, each fatal on failure:

1. Device: the card's name and power limit (nvidia-smi), and the list
   of hand-written kernels on the path (none in this slice).
2. Fleet replay at full width: ``ppo-cnn-philly512`` (64 nodes x 8
   GPUs, 128-job windows, queue 16, horizon 1024, the CNN actor-critic
   in bf16 with seeded weights) against 512 simulated clusters through
   ``fleet_replay``; then a ``torch.profiler`` account of the decision
   step (launches per step, top device ops, device idle share).
3. Card against CPU: the first 4 clusters replayed at f32 with TF32
   off on ``cuda`` and on ``cpu`` with the same weights. Greedy actions
   must agree step by step, except at a step where the CPU's top-two
   logit margin is below 1e-4; that cluster is no longer compared from
   there on. Clusters compared to the end must agree on ``steps`` and
   ``n_done`` exactly and on ``avg_jct`` within rtol 1e-6 (an f32 sum
   over the window, whose order differs between the devices).
4. Requests: a pool of (obs, mask) rows the greedy policy reaches on
   the config-2 env goes through ``InferenceEngine`` (the eager
   decision, ``eager=True``) after a warmup up
   to bucket 256; three request sizes in each of two buckets. Served
   actions must equal ``policy_decision`` on the same rows (padded to
   the bucket: exactly; unpadded: up to the phase-3 margin rule). Prints
   p50/p99 ``decide`` latency per bucket.
5. Training at published geometry: ``Experiment.build`` of
   ``ppo-cnn-philly512`` on the card (bf16 trunk, seeded init; 8 envs x
   128 steps, 4 epochs x 4 minibatches of 256), one warm-up iteration
   through ``Experiment.run``, then three iterations timed stage by
   stage (rollout, GAE + normalization, update; the card synchronized
   around each), env-steps/s over those three, a ``torch.profiler``
   account of one more iteration (device ops and busy time per rollout
   step and per minibatch update, idle share), one iteration under
   torch's sync debug mode set to raise (the loop must not wait for the
   card) and the peak memory. Loss, entropy and approx-KL must be
   finite; parameters, grads and Adam moments f32, the trunk's output
   bf16.
6. ``ppo-mlp-synth64`` at ``bench.py``'s chip geometry (512 envs x 128
   steps, 2 epochs x 8 minibatches): one warm-up iteration, then three
   through ``Experiment.run``; prints env-steps/s.
7. Card against CPU at f32 with TF32 off and deterministic cuDNN, on
   config 2's CNN with the same seeded weights on both: a 128-step
   rollout of 8 clusters sampled on the card, whose first 32 steps the
   CPU replays with the card's actions (obs, mask, reward and done must
   be bit-identical; a probe counts the inputs on which f32 tanh differs
   between the devices, the reason the observations take it in f64);
   then one learn step on the card's batch with the
   same permutations on both sides (parameters within atol 1e-5,
   metrics within rtol 1e-4 / atol 1e-6, the CPU parity tests'
   tolerances).
8. Config 2's JCT table at full width: ``jct_report`` on 64 held-out
   streaming windows (seed ``cfg.seed + 1000``, 128 jobs each, 512
   GPUs), ``max_steps`` 4096, the baselines on the native engine,
   p50/p90/p99 columns, after the native engine's first-use build
   (timed), and after 63 steps of the gated greedy and of the random
   replay under torch's sync debug mode set to raise (the loop may wait
   for the card only at its every-64-steps check). The policy is the
   seeded init in bf16; then the policy row again with the weights
   phase 5 trained. Prints every row, the completion, ``vs_tiresias``,
   the wall time of the policy replay, the random replay and the
   baselines (the card synchronized around each), and the policy
   replay's decision steps and decisions/s. Every value must be finite
   and the completion reported.
9. Card against CPU, and native against Python, on 4 of those windows
   at f32 with TF32 off: the greedy replay's actions identical under
   phase 3's margin rule, and for the windows compared to the end
   ``n_done``, ``steps`` and every per-job JCT identical (the policy
   row within rtol 1e-6, an f32 mean whose summation order differs by
   device); the ``backlog_gate=4`` replay's actions identical under the
   same rule; the four baselines on the native engine against the
   Python oracle, finish and start within atol 1e-6, status equal, avg
   JCT within rel 1e-9 (``tests/test_torch_oracle.py``'s tolerances),
   with the time per window of each backend.
10. The entry points, each of which must return:
    ``python -m rlgpuschedule_tpu_torch.evaluate --config
    ppo-cnn-philly512 --eval-windows 4 --max-steps 4096 --percentiles``
    and ``python -m rlgpuschedule_tpu_torch.train --config
    ppo-mlp-synth64 --iterations 4 --eval-every 2 --report``; their JSON
    lines (the probe rows and the report) are echoed.
11. The preemptive and pack|spread action spaces, for
    ``ppo-mlp-preempt`` (8x8 GPUs, queue 8, 4 preempt slots, the MLP)
    and ``gnn-gang-place`` (16x8 GPUs in racks of 4, queue 8, pack|spread,
    the GNN over the 24-node topology graph), each at its published
    width: ``fleet_replay`` of 512 seeded clusters at horizon 512
    (bf16, seeded weights) with decisions/s, device ops per decision
    step and the unprofiled idle share (phase 2's profile over 4 and 12
    steps); card against CPU at f32 on 4 clusters under phase 3's rule,
    at the preset's horizon; and a host-drawn
    (numpy, seeded) masked-uniform action sequence fed through
    ``env.step`` on both devices on integer-valued traces, the sim
    state, mask and reward bit-identical at every step. Then a policy
    made to cycle (biases on preempting running slot 0 and placing
    queue slot 0) replays ``ppo-mlp-preempt``: with the stall guard on
    every job must finish, with it off none may. The phase prints the
    spread placements and preemptions the feeds made and the stall
    gate's engagements, and fails if any of the three totals is zero.
12. Training and evaluation of both presets on the card: one warm-up
    and three timed PPO iterations at the published geometry (4 envs x
    128 steps, 4 epochs x 4 minibatches; env-steps/s, the rollout / GAE
    / update split, finite losses); one learn step card against CPU at
    f32 (parameters within atol 1e-5, phase 7's rule); ``jct_report``
    on 16 held-out windows (every row finite, completion printed,
    ``stall_guard`` recorded for ``ppo-mlp-preempt``); and the
    ``evaluate`` CLI for ``gnn-gang-place`` (its ``main``, in this
    process).

13. The continuous-batching policy server of config 2 at full width
    (bf16, seeded weights) on one CUDA graph per bucket, the request
    pool phase 4's (64 clusters, 5 steps), each check fatal: (1)
    ``InferenceEngine(max_bucket=256)`` warms buckets 1-256 with 9
    captures and 0 recompiles; (2) for phase 4's sizes the replayed
    actions equal eager ``policy_decision`` on the same padded batch,
    except rows whose top-two margin is below 1e-4 (their count
    printed), with the graph's ``decide`` p50/p99 at buckets 16 and 256
    beside phase 4's eager figures; (3) ``run_bench`` over sizes 5, 7,
    8, 100, 129, 200, 256 for 48 rounds, 0 recompiles and 0 dispatch
    errors, p50/p99 and decisions/s printed; (4) the sync guard: a
    steady-state copy-in and replay under it raises nothing, a
    deliberate ``.item()`` raises; (5) other seeded weights swapped in
    and ``rewarm()``: 0 captures, actions equal eager on the new
    weights; swapped back, step 2's actions bit for bit; (6)
    ``ppo-mlp-preempt``'s engine with ``env_params``: the graph with the
    stall vector equals eager ``gate_stalled`` + ``policy_decision``;
    (7) a 4 s soak at 2,000 requests/s through the dispatcher thread,
    50 ms deadlines: every request served or shed (the registry's
    counts agree), some served in the second half (a server locked out
    by its admission estimate serves none there), at most 1 % shed (a
    pause learned as service time sheds thousands), 0 recompiles, 0
    dispatch errors, shed rate, p99 per half, drift and the rate
    achieved printed (steps 3 and 7 also print
    the garbage collector's full collections and longest pause);
    (8) ``run_host_path``
    (bucket 256, 300 rounds): the arena arm allocates nothing; (9)
    ``python -m rlgpuschedule_tpu_torch.serve --config ppo-cnn-philly512
    --bench --bucket 256`` exits 0 with 0 post-warmup recompiles.
14. Checkpoints of config 2 at its published geometry (bf16, 8 envs x
    128 steps, 4 x 4 minibatches) with half the envs drained and a
    window resample every 2 iterations, under torch's default cuDNN
    switches (TF32 on, not deterministic; phases 3-9 leave them off and
    on, and they are put back after): 4 iterations with a checkpoint
    every 2; a fresh ``Experiment`` restores the iteration-2 step (taken
    just before a resample) and runs 2 more, and its parameters, Adam
    moments and step, rollout carry and both generators' states must be
    the uninterrupted run's bit for bit (else a second uninterrupted run
    measures the card's run-to-run difference, and the resume must stay
    within 10x of it); the checkpoint's bytes and the milliseconds to
    save and to restore are printed. The newest step's payload is then
    truncated: ``restore()`` must fall back to the older step and say
    so. ``evaluate --ckpt-dir --drain-frac 0.5`` and ``serve --ckpt-dir
    --fleet 64`` on the card must restore that step and
    equal the same replays in this process, row for row and cluster for
    cluster. Last, the checkpoint on the CPU: a CPU experiment must
    refuse to continue its CUDA generators, and its policy at f32 (TF32
    off) replays 4 of the windows (2 streaming, 2 drained) on the card
    and on the CPU within phase 9's margin rule.
15. ``ppo-mlp-synth64`` at its preset on the drain curriculum
    (``drain_frac=1.0``): 6 iterations, a checkpoint every 2, 3 kept;
    ``python -m rlgpuschedule_tpu_torch.select_checkpoint`` ranks them
    by full-trace avg JCT over Tiresias on a 128-job seed-2000
    validation stream (the reference's default is 1,024 jobs); the
    chosen step's ``full_trace_report`` over a 128-job seed-123 stream
    (``drain_completions=8``), every row finite, over at least 2
    windows (one window stitches nothing: no carry, cutoff or drain);
    and that stitched
    replay at f32 on the card and on the CPU: the same number of windows
    and the avg JCT within rtol 1e-6, unless a decision where the CPU's
    top-two margin is below 1e-4 differs, and then the phase names the
    first divergent window. Prints the ranking, the windows, the rows
    and the wall time of each part.

16. Config 3, ``a2c-pai-fair``, at its published width (16 nodes x 8
    GPUs, 16 envs x 16 steps, 8 tenants, 96-job PAI-proxy windows, the
    fairness reward, A2C with RMSprop, bf16 trunk): one warm-up and 20
    timed iterations through ``Experiment.run`` (env-steps/s), one
    rollout and one iteration under ``torch.profiler`` (device ops per
    rollout step, idle share), one iteration under sync debug mode
    "error"; finite losses, f32 parameters, grads and RMSprop state.
    Card against CPU at f32 with TF32 off: a 32-step rollout sampled on
    the card and replayed on the CPU with its actions (obs, mask, the
    fair reward, done and dt bit-identical, some reward charged), then
    one A2C learn step on its first 16 steps (parameters within atol
    1e-5, metrics within phase 7's rule). ``fairness_report`` of the
    trained policy on 16 held-out windows (seed ``cfg.seed + 1000``),
    printed with its Jain column, every row finite; and ``evaluate
    --fairness`` (its ``main``, in this process), restoring that policy
    from a checkpoint, equal to it row for row.
17. Config 1 at its preset with each option: one iteration each with
    ``reward_norm``, ``bf16_update`` and ``bf16_advantages`` (finite
    metrics; f32 parameters, grads and Adam moments; the advantages
    bf16 only under ``bf16_advantages``; the reward moments counted);
    a reward-norm run of 2 iterations, a checkpoint and 2 more against
    a fresh experiment restored from it, bit for bit in every payload;
    and PPO's V-trace recompute on on-policy rollouts of an f32 and a
    bf16-trunk policy: the largest ``|rho - 1|`` (one batched ``[T*E]``
    forward against the rollout's per-step ``[E]`` ones, which cuBLAS
    may compute with other kernels), held to 1e-5 (f32) and 5e-2 (bf16),
    and the targets against the GAE path.
18. ``run_fused(2)`` against 2 iterations of ``run`` from fresh builds of
    config 1 at the bench geometry (512 envs x 128 steps, 2 x 8), bit
    for bit under torch's default cuDNN switches (else within 10x of a
    second plain run's difference); then ``python -m
    rlgpuschedule_tpu_torch.bench`` in a process of its own, its JSON line
    (median env-steps/s, spread, the card's name and power limit)
    printed.

19. Config 5, ``hier-pbt-member``, at its published width (16 nodes x 8
    GPUs in 4 pods, 4 envs x 128 steps, 64-job windows, 4 x 4
    minibatches, the hierarchical actor-critic with bf16 trunks). Card
    against CPU at f32 with TF32 off on integer traces: a 32-step
    hierarchical rollout sampled on the card and replayed on the CPU with
    its joint actions (obs, mask, actions, reward, done and dt
    bit-identical, some routes taken), then one member learn step on its
    batch with the same permutations and hyperparameters (parameters
    within atol 1e-5, metrics within phase 7's rule). One hierarchical
    ``Experiment``: a warm-up and 3 timed iterations (env-steps/s), a
    16-step rollout under ``torch.profiler`` (device ops per rollout
    step, idle share), finite losses. A ``PopulationExperiment``
    of 4 members exploiting every 2 iterations: 2 iterations, a
    checkpoint (bytes, save ms), 1 more, a snapshot, 1 more; at least one
    PBT round, finite fitness, every member exploited in the last round
    holding its source's parameters (the ms of the exploit's weight
    copy printed, and the env-steps/s over ``T*E*P`` per iteration); a
    fresh population restored from the checkpoint (restore ms) and run 1
    iteration must equal the snapshot bit for bit (parameters, Adam
    state, carries, generators, hyperparameters, decisions). Then the
    fittest member's ``jct_report`` on 8 held-out windows (seed
    ``cfg.seed + 1000``) against FIFO, SJF, SRTF and Tiresias, every row
    finite, completion and ``vs_tiresias`` printed; and ``evaluate
    --pbt`` (its ``main``, in this process) from the population's
    checkpoint, equal to it row for row.

20. The multi-engine router of config 2 at full width (bf16, seeded
    weights; phase 13's 320-row pool) with its engines sharing the card,
    each on its own CUDA stream, and config 5 through one engine and the
    server, each check fatal: (1) ``run_scaleout`` with 1 and 2 engines
    (sizes 129, 200, 256 for 64 rounds, every arm's engines warmed one
    after another before its dispatchers start): per-engine rows,
    occupancy and recompiles (all 0), decisions/s per arm, every request
    served; (2) a 2-engine router and a lone engine decide phase 4's
    batches: the actions equal under phase 3's margin rule; (3) a 4 s
    routed soak at 2,000 requests/s (50 ms deadlines) over 2
    dispatchers with the autoscale advisor (p99 target 1 ms, hysteresis
    2) and engine 1 cold at the start: the advisor spins it up under
    load (its graphs captured while engine 0 replays), it serves rows,
    every request is served or shed, some in the second half, 0
    recompiles on both engines; (4) a 4 s chaos soak at 1,000
    requests/s paced by config 2's fitted trace with ``engine-raise``,
    ``engine-hang`` and ``engine-slow`` on engine 1: every fault fires,
    ``submitted == served + shed + failed`` with ``failed == 0``, the
    hedges and failures printed, 0 recompiles; (5) config 5
    (``hier-pbt-member``, f32, the first of 8 seeds whose greedy top
    head routes a row and plays two actions on its own 32-row pool of
    the env, its policy heads scaled by 300): a graph engine's per-head
    actions equal an eager engine's on the card and a CPU engine's
    under phase 3's margin rule, at sizes 5, 17 and 32, and some rows
    are routed to a pod (the routable rows and routes served printed;
    a pool where every row plays no-op would hold the top head to one
    constant action); then ``python -m rlgpuschedule_tpu_torch.serve
    --config hier-pbt-member --bench --soak 2 --bucket 64`` exits 0 with
    0 recompiles and every soak request served or shed.

21. Cluster chaos and domain randomization (each check fatal): config
    2 at full width (bf16, seeded weights) replays the 512-cluster fleet
    clean and under ``storm`` schedules from ``sample_fleet_faults``
    (what ``serve --fleet-regime storm`` runs), each profiled over 4 and
    12 steps (device ops per step, idle share); then ``eval.replay``
    under a ``mixed`` ``DomainSchedule`` over 512 windows from
    ``make_domain_windows``.
    For each schedule the first 2 clusters replay on the card with the
    policy and on the CPU with the card's actions fed back: the final
    states, the per-job JCTs and every ``EvalResult`` field must be
    bit-identical, but ``avg_jct`` (an f32 sum whose order differs
    between the devices) within rtol 1e-6. Config 1
    (``ppo-mlp-synth64``, its preset width) trains clean, with
    ``--faults storm`` and with ``--domains mixed`` through the train
    CLI's ``main`` (1 iteration each, env-steps/s printed side by side);
    ``evaluate --chaos`` over none, sporadic,
    storm and straggler and ``evaluate --matrix`` over none, baseline,
    hetero and overload run on the trained checkpoints (every cell's
    conservation check holds, 0 jobs lost), and each table's policy rows
    equal the same report's on the CPU (f32 weights from the
    checkpoint, TF32 off; a row that differs is replayed on both devices
    and held to phase 9's margin rule), the baseline rows exactly.

22. The network front door (each check fatal): config 2 at full width
    (bf16, seeded weights) on one ``InferenceEngine`` warmed to bucket
    256 on the main thread, a ``PolicyServer`` on the arena plane (the
    sync guard on in every dispatch) and ``start_frontend(port=0)``.
    Every row of a 320-row pool is first served in process
    (``submit``, inline pump); then 8 HTTP keep-alive clients and 8
    framed clients, one process each, send 250 requests each over
    real sockets, each with its own request id: every reply echoes its
    id, and every action equals the in-process one for its row, but at
    a top-two margin below 1e-4 (the flips counted and printed);
    decisions/s and per-request p50/p99 per dialect, at the client and
    as the server measured them (submit to result). A burst of 10 us
    deadlines on 4 connections of each dialect answers only 200/RESP or
    503/``shed:`` frames, some shed, every ``Retry-After`` in [0.01, 30]
    s. With 4
    idle keep-alive connections open the drain ends within 10 s, a late
    ``submit`` raises ``ServerClosedError``, an idle client's next
    request gets 503 ``closed`` and every idle connection reads an EOF;
    ``serve_requests_total`` equals served plus shed, 0 dispatch errors,
    0 recompiles, the sync-debug mode back at 0. 32 requests past a
    high-water mark of 8 with no dispatcher pause the reads, and all 32
    answer 200 once it starts. Then ``serve --config
    ppo-cnn-philly512 --bucket 256 --soak 4 --frontend-port 0 --obs-dir
    D --trace-spans --host-path --wire-requests 500`` (self-check 200,
    ``server-closed``, ``refused``; then both wire arms' decisions/s,
    the arena arm's allocations 0), then ``python -m
    rlgpuschedule_tpu_torch.obs.report D --request ID --json`` for the
    self-check's id (stages ``enqueue`` then ``served``) and
    ``--strict-alarms`` (exit 0). Every line carries the card's name and
    power limit.
23. The data flywheel (each check fatal): config 2 at full width (bf16,
    seeded weights, phase 22's 320-row pool). (1) A plain and a capture
    ``InferenceEngine`` warmed to bucket 256: graph ``decide`` p50 of
    each at phase 4's sizes of buckets 16 and 256; the capture graph's
    actions equal the plain graph's at every size, and its log-prob and
    value against ``policy_decision_full`` on the CPU copy of the policy
    hold phase 17's bf16 band (``|mean ratio - 1|`` and the value's
    largest relative difference within 5e-2). (2) Two 2 s soaks at
    2,000 requests/s (50 ms deadlines) through the capture engine, one
    without a flight log and one with the durable log (512-row shards,
    fsync), its writer on the dispatcher thread under the sync guard:
    decisions/s, p99 halves and shed of each; ``rows_logged == served``,
    the crc-verified reload holds every row with a unique request id, 0
    dispatch errors and recompiles, the sync-debug mode back at 0. (3)
    ``run_continual`` over that log for 2 learn steps, the learner
    starting from the served weights (saved first as step 0): 0 shards
    refused, every shard's ``|rho_mean - 1|`` within 5e-2, the loss
    finite. (4) The incumbent's replay of the logged window: every row
    it decides otherwise than the log has a top-two margin below 1e-4
    (the disagreements and near ties printed). (5) ``python -m
    rlgpuschedule_tpu_torch.serve --flight-log D --durable-log
    --promote-noise 0.5`` is blocked, then ``--promote CKPTDIR
    --promote-fault --canary-tol 1.0`` promotes the retrained candidate
    (the canary still runs and is recorded) with 0 swap recompiles,
    rolls back on the injected p99 breach with the probe bit for bit, and
    the ledger reads ``blocked, promote, rollback``.
24. Run-loop observability (each check fatal), config 1: (5b)
    ``profile_breakdown --sweep-minibatch`` (its ``main``, in this
    process under torch's default switches) at 64 envs x 128 steps (one
    repeat): ranked fastest first; then side by side (no wall or rate
    of theirs is kept) ``bench --sweep`` on that artifact on the host
    CPU (it must run the sweep's best geometry; the card's bench is
    phase 18's), (1) ``train
    --obs-dir --alarms --trace-spans --log-csv --tb-dir`` at the
    preset's width (4 envs x 128 steps, 3 iterations: 3 iteration events,
    0 recompile and 0 transfer events, the CSV and the TensorBoard file
    written), (2) the same with ``--alarm-slow-iter 0.001`` (slow
    iterations, exactly one profiler capture under ``<obs>/profile``
    holding CUDA kernel events), (4) ``evaluate --matrix --obs-dir
    --alarms``, and in this process (3) an ``Alarms`` scope: a warm
    engine dispatch stays clean under the sync guard, a forced
    ``.item()`` raises ``AlarmError`` with a ``transfer`` event, and a
    dispatch at a bucket the engine never captured (guard off: a capture
    synchronizes) is a ``recompile``; (6) ``debug_checks`` passes a clean
    iteration and raises ``FloatingPointError`` on a NaN weight.
    ``obs.report --strict-alarms`` (its ``main``) exits 0 on (1) and (4)
    and 1 on (2). (5) ``profile_breakdown`` (its ``main``) at 512 x 128,
    ``--repeats 1`` of 3 calls, alone: every stage's wall, its event-pair
    span and its busy milliseconds on the card (the profiler's kernel
    intervals), the sum of the parts against the fused loop,
    ``mfu_update`` priced on the card's bf16 peak, and a ``--trace-dir``
    capture. Phase 25's (a) and (d), which check bits and not time, run
    in this process while the children of (1), (2), (4) and the bench
    run.
25. The async actor-learner (each check fatal): (a) config 2 at its
    preset width (8 envs x 128 steps, the 2.68 M-parameter CNN, cuDNN
    deterministic on both arms) with window streaming every 2
    iterations: ``Experiment.run(3)`` against ``run_async(3,
    staleness_bound=0)`` across the resample barrier, every parameter,
    optimizer, carry and generator element and the host counters equal
    (the count of differing elements printed); (b) config 1 at 512 envs
    x 128 steps, bound 1, 4 iterations under ``RunTelemetry(alarms=True,
    trace=True)``: 0 ``transfer`` and 0 ``recompile`` events,
    ``staleness_max``, ``overlap_s``, busy and idle seconds of each
    loop and the span timeline's ``async_overlap_measured``; then one
    profiled window of 2 iterations: each card stream's busy ms (the
    profiler's kernel intervals) and the ms the streams overlap; (c)
    ``train --async --staleness-bound 4 --queue-capacity 4 --correction
    vtrace`` (its ``main``; 16 steps, 4 epochs x 16 minibatches, so the
    update is the longer loop) for 8 iterations with a checkpoint every
    4: ``staleness_max > 1``, finite losses, ``rho_mean``/``rho_max``,
    the last checkpoint's ``async_iteration`` and ``staleness_bound``;
    (d) a population of 2 config-1 members (32-step rollouts, exploit
    every 2): the sync population against ``run_async`` at bound 0 for
    4 iterations, every element equal, 2 PBT rounds; (e) ``bench --async
    --staleness-bound 1 --repeats 1`` (its ``main``; one call of 5
    iterations an arm, as (b) measures the engine already): its line,
    sync and async env-steps/s of this process (not phase 18's),
    ``speedup`` and ``projected_overlap_speedup``.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it is the card's name and power limit. Without a CUDA device, or
without the ``rlgpuschedule_tpu_torch`` package beside it, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

CONFIG = "ppo-cnn-philly512"
N_CLUSTERS = 512          # the serve CLI's documented --fleet 512
N_COMPARE = 4             # clusters card against CPU (phases 3, 11)
MARGIN = 1e-4
BUCKETS = {16: (9, 12, 16), 256: (129, 200, 256)}
LATENCY_REPS = 30
TRAIN_TIMED = 3           # timed iterations after one warm-up
BENCH_CONFIG = "ppo-mlp-synth64"
BENCH_GEOMETRY = dict(n_envs=512, n_steps=128, n_epochs=2, n_minibatches=8)
REPLAY_STEPS = 32
PARAM_ATOL, METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-4, 1e-6
EVAL_WINDOWS = 64         # held-out windows of the phase-8 table
EVAL_STEPS = 4096         # decision steps per window
EVAL_COMPARE = 4          # windows compared card against CPU (phase 9)
GATE = 4
PERCENTILES = (50, 90, 99)
NEW_PRESETS = ("ppo-mlp-preempt", "gnn-gang-place")
NEW_HORIZON = 512         # phase 11's fleet replay
FEED_CLUSTERS, FEED_STEPS = 64, 128
# the cycling policy spends up to stall_threshold + 1 = 17 steps on each
# event: 32-job windows (half the preset's) finish in about 2,000 steps
CYCLE_CLUSTERS, CYCLE_JOBS, CYCLE_STEPS, UNGUARDED_STEPS = 16, 32, 4096, 128
NEW_EVAL_WINDOWS = 16
SERVE_SIZES = (5, 7, 8, 100, 129, 200, 256)   # phase 13's bench
SERVE_ROUNDS = 48
SOAK_S, SOAK_RATE, SOAK_DEADLINE_S = 4.0, 2000.0, 0.05
SOAK_MAX_SHED = 0.01      # of phase 13's soak requests (fatal above)
HOST_ROUNDS = 300
CKPT_DRAIN, CKPT_RESAMPLE, CKPT_ITERS = 0.5, 2, 4   # phase 14
CKPT_FLEET = 64           # serve --ckpt-dir --fleet 64
CKPT_COMPARE_FROM = 2     # phase 14 replays windows 2-5: 2 of each kind
SELECT_ITERS = 6          # phase 15: 3 checkpoints kept, one every 2
SELECT_VAL_JOBS, SELECT_TEST_SEED, SELECT_TEST_JOBS = 128, 123, 128
SELECT_STITCH_DRAIN = 8
FAIR_CONFIG = "a2c-pai-fair"
FAIR_TIMED = 20           # phase 16: timed A2C iterations after a warm-up
FAIR_WINDOWS = 16         # phase 16's held-out fairness table
FAIR_REPLAY_STEPS = 32    # phase 16's rollout replayed on the CPU
# phase 17: the on-policy V-trace ratio band on the card, per trunk
# dtype (the recompute is one [T*E] batch, the rollout's [E] per step)
RHO_BAND = {"float32": 1e-5, "bfloat16": 5e-2}
FUSED_ITERS = 2           # phase 18: run_fused(2) against run(2)
HIER_CONFIG = "hier-pbt-member"
HIER_REPLAY_STEPS = 32    # phase 19's rollout replayed on the CPU
HIER_TIMED = 3            # phase 19: timed iterations after a warm-up
HIER_PROFILE_STEPS = 16   # phase 19's profiled rollout
HIER_POP = 4              # phase 19's population
HIER_READY = 2            # its exploit/explore cadence
HIER_POP_ITERS = 4
HIER_RESUME = (2, 1)      # 2 iterations, a save, 1 more against 3
HIER_WINDOWS = 8          # phase 19's held-out JCT table
ROUTER_SIZES = (129, 200, 256)  # phase 20's scale-out request sizes
ROUTER_ROUNDS = 64
ROUTER_SOAK_S, ROUTER_RATE = 4.0, 2000.0
ROUTER_P99_TARGET_MS = 1.0      # low on purpose: the advisor must spin up
CHAOS_S, CHAOS_RATE = 4.0, 1000.0
CHAOS_FAULTS = ("engine-raise@20:engine=1,engine-hang@60:engine=1,"
                "engine-slow@100:engine=1")
HIER_SERVE_SIZES = (5, 17, 32)
HIER_SERVE_SEEDS = 8      # phase 20 (5): seeds tried for weights that route
CHAOS_COMPARE = 2         # phase 21: clusters replayed card against CPU
CHAOS_TRAIN_ITERS = 1     # phase 21: config-1 train CLI runs
FRONTEND_CLIENTS = 8      # phase 22: clients of each dialect
FRONTEND_REQUESTS = 250   # phase 22: requests each client sends
FRONTEND_DRAIN_BOUND_S = 10.0   # phase 22: the drain's bound
FRONTEND_WIRE_REQUESTS = 250    # phase 22: serve --wire-requests
FLY_SOAK_S, FLY_RATE, FLY_DEADLINE_S = 2.0, 2000.0, 0.05   # phase 23
FLY_CAPACITY = 512        # phase 23: flight-log rows per shard
OBS_ITERS = 3             # phase 24: train CLI iterations per run
OBS_SLOW_S = 0.001        # phase 24: --alarm-slow-iter, below any iteration
OBS_NAN_STEPS = 16        # phase 24: the rollout of the --debug-nans run
BREAKDOWN_GEOMETRY = ("512", "128")   # phase 24: the breakdown's envs x steps
SWEEP_GEOMETRY = ("64", "128")   # phase 24: the sweep's envs x steps
SHORT_PROFILE = (4, 12)   # phases 11 and 21: the replay lengths profiled
KERNEL_EVENT = b'"cat": "kernel"'  # a card kernel in a torch Chrome trace
BREAKDOWN = "rlgpuschedule_tpu_torch.profile_breakdown"
ASYNC_ITERS = 3           # phase 25 (a): run(3) against run_async(3)
ASYNC_RESAMPLE = 2        # its window streaming: one resample barrier
ASYNC_TEL_ITERS = 4       # phase 25 (b): bound 1 under the alarms
ASYNC_PROFILE_ITERS = 2   # its profiled window
ASYNC_DEEP_ITERS = 8      # phase 25 (c): bound 4 through the train CLI
# (c)'s geometry: a short rollout and a long update, so the learner is
# the slower loop and the queue runs deep
ASYNC_DEEP_GEOMETRY = ("--n-steps", "16", "--n-epochs", "4",
                       "--n-minibatches", "16")
ASYNC_POP = 2             # phase 25 (d): config-1 members
ASYNC_POP_STEPS = 32      # their rollout
ASYNC_POP_ITERS = 4
ASYNC_POP_READY = 2
ASYNC_BENCH_REPEATS = 1   # phase 25 (e): bench --async calls an arm
FLY_ITERS = 2             # phase 23: continual learn steps
# phase 23: the soak arms in run order, each twice more after its first
# place (A B B A A B), so neither arm always runs first
FLY_ARMS = ("no_log", "durable_log", "durable_log", "no_log", "no_log",
            "durable_log")
ROWS = ("policy", "random", "fifo", "sjf", "srtf", "tiresias")
BASELINES = ("fifo", "sjf", "srtf", "tiresias")


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _line(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def _finite(*xs) -> bool:
    return all(math.isfinite(float(x)) for x in xs)


def fleet_phase(torch, cfg, env_params, traces, dev):
    from rlgpuschedule_tpu_torch.experiment import build_policy
    from rlgpuschedule_tpu_torch.serve.fleet import fleet_replay

    policy = build_policy(cfg, env_params, device=dev)
    # first-call costs (allocator, cuDNN/cuBLAS handles) outside the
    # timed run
    fleet_replay(policy, env_params, traces, max_steps=4, device=dev)
    fl = fleet_replay(policy, env_params, traces, device=dev)
    pc = fl["per_cluster"]
    _line("fleet", config=cfg.name, n_clusters=fl["n_clusters"],
          horizon=env_params.horizon, dtype="bfloat16",
          decisions=fl["decisions"], wall_s=fl["wall_s"],
          decisions_per_s=fl["decisions_per_s"],
          mean_jct=fl["mean_jct"], completion=fl["completion"],
          max_steps_taken=max(pc["steps"]), min_steps_taken=min(pc["steps"]))
    if not fl["completion"] > 0:
        raise SystemExit("fleet replay completed no job")
    if not _finite(fl["mean_jct"], fl["completion"], fl["wall_s"],
                   fl["decisions_per_s"], *pc["avg_jct"], *pc["makespan"]):
        raise SystemExit("fleet replay reported a non-finite value")
    return policy


def profile_phase(torch, env_params, traces, policy):
    """Phase 2's profile of the decision step, printed."""
    _line("profile", **_replay_profile(torch, env_params, traces, policy))


def _replay_profile(torch, env_params, traces, policy, s1=8, s2=40,
                    faults=None):
    """Kernel launches per decision step, from the difference of two
    replay lengths (which cancels reset and final statistics); device
    time by op and the device idle share over the longer one, with and
    without the profiler's own overhead on the host; and the policy's
    share of a step. ``faults``: the batched schedules replayed
    under."""
    from torch.profiler import ProfilerActivity, profile

    from rlgpuschedule_tpu_torch.env import env as env_lib
    from rlgpuschedule_tpu_torch.eval import replay

    def timed(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay(policy, env_params, traces, max_steps=steps, faults=faults)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def run(steps):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = timed(steps)
        device_ops = [e for e in prof.events()
                      if e.device_type.name == "CUDA"]
        return prof, device_ops, wall

    _, k1, _ = run(s1)
    prof, k2, wall = run(s2)
    wall_plain = timed(s2)
    busy_s = sum(e.time_range.elapsed_us() for e in k2) / 1e6
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in k2)
    ops = sorted(((e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.key.startswith("aten::")
                  and e.self_device_time_total > 0),
                 key=lambda r: -r[1])[:10]
    # the policy alone on the replay's first observation, CUDA events
    with torch.inference_mode():
        _, ts = env_lib.reset(env_params, traces, faults)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        policy(ts.obs, ts.action_mask)
        start.record()
        for _ in range(20):
            policy(ts.obs, ts.action_mask)
        end.record()
        torch.cuda.synchronize()
    if not k2:
        raise SystemExit("the profiler saw no kernel on the card")
    return dict(
        steps=s2, device_ops=len(k2), copies_and_sets=copies,
        launches_per_step=(len(k2) - len(k1)) / (s2 - s1),
        device_busy_s=busy_s, window_s=wall,
        device_idle_share=1.0 - busy_s / wall,
        window_s_unprofiled=wall_plain,
        device_idle_share_unprofiled=1.0 - busy_s / wall_plain,
        step_ms_unprofiled=wall_plain / s2 * 1e3,
        policy_forward_ms=start.elapsed_time(end) / 20,
        top_device_ops=[{"op": k, "device_ms": t / 1e3, "calls": c}
                        for k, t, c in ops])


def compare_phase(torch, cfg, env_params, windows, dev):
    from rlgpuschedule_tpu_torch.env import stack_traces
    from rlgpuschedule_tpu_torch.eval import replay
    from rlgpuschedule_tpu_torch.experiment import build_policy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sub = windows[:N_COMPARE]
    out = {}
    for side in (dev, "cpu"):
        policy = build_policy(cfg, env_params, dtype=torch.float32,
                              device=side)
        traces = stack_traces(sub, env_params, side)
        res, rec = replay(policy, env_params, traces, record=True)
        out[side] = ({k: v.cpu() for k, v in res._asdict().items()},
                     rec.actions.cpu(), rec.margin.cpu())
    (rg, ag, _), (rc, ac, mc) = out[dev], out["cpu"]
    cut, compared = {}, []
    for e in range(N_COMPARE):
        n = min(int(rg["steps"][e]), int(rc["steps"][e]), ac.shape[0],
                ag.shape[0])
        diff = (ag[:n, e] != ac[:n, e]).nonzero().flatten()
        if diff.numel():
            s = int(diff[0])
            if float(mc[s, e]) >= MARGIN:
                raise SystemExit(
                    f"cluster {e}: card and CPU actions differ at step {s} "
                    f"where the CPU's top-two margin is {float(mc[s, e])}")
            cut[e] = (s, float(mc[s, e]))
            continue
        compared.append(e)
        for k in ("steps", "n_done"):
            if int(rg[k][e]) != int(rc[k][e]):
                raise SystemExit(f"cluster {e}: {k} {int(rg[k][e])} on the "
                                 f"card vs {int(rc[k][e])} on the CPU")
    rel = max((abs(float(rg["avg_jct"][e]) - float(rc["avg_jct"][e]))
               / max(abs(float(rc["avg_jct"][e])), 1e-30)
               for e in compared), default=0.0)
    _line("card_vs_cpu", config=cfg.name, clusters=N_COMPARE,
          dtype="float32", tf32=False,
          compared_to_end=len(compared),
          cut_short={str(e): {"step": s, "cpu_margin": m}
                     for e, (s, m) in cut.items()},
          steps=[int(x) for x in rc["steps"]],
          n_done=[int(x) for x in rc["n_done"]],
          avg_jct_max_rel_diff=rel)
    if rel > 1e-6:
        raise SystemExit(f"avg_jct differs by {rel} (relative) between the "
                         f"card and the CPU")
    if not compared:
        raise SystemExit("no cluster was compared to the end")


def request_phase(torch, env_params, traces, policy, dev):
    import numpy as np

    from rlgpuschedule_tpu_torch.decision import policy_decision
    from rlgpuschedule_tpu_torch.env import env as env_lib
    from rlgpuschedule_tpu_torch.serve import InferenceEngine, pad_batch

    # the request pool: rows the greedy policy reaches in 64 clusters
    sub = type(traces)(*(x[:64] for x in traces))
    rows_obs, rows_mask = [], []
    with torch.inference_mode():
        state, ts = env_lib.reset(env_params, sub)
        for _ in range(5):
            rows_obs.append(ts.obs.cpu().numpy())
            rows_mask.append(ts.action_mask.cpu().numpy())
            a = policy_decision(policy, ts.obs, ts.action_mask)
            state, ts = env_lib.vec_step(env_params, state, sub, a)
    obs = np.concatenate(rows_obs)
    mask = np.concatenate(rows_mask)

    # the eager decision on the card (the plain version phase 13's CUDA
    # graphs are held against)
    engine = InferenceEngine(policy, max_bucket=256, device=dev,
                             eager=True)
    warmed = engine.warmup(obs[0], mask[0])
    latency, loose = {}, 0
    for bucket, sizes in BUCKETS.items():
        lat = []
        for n in sizes:
            rows = np.arange(n) * 7 % obs.shape[0]
            got, b = engine.decide(obs[rows], mask[rows])
            if b != bucket:
                raise SystemExit(f"{n} requests went to bucket {b}")
            with torch.inference_mode():
                o = torch.from_numpy(obs[rows]).to(dev)
                m = torch.from_numpy(mask[rows]).to(dev)
                padded = policy_decision(
                    policy,
                    torch.from_numpy(pad_batch(obs[rows], b)).to(dev),
                    torch.from_numpy(pad_batch(mask[rows], b, True)).to(dev))
                logits, _ = policy(o, m)
            if not np.array_equal(got, padded.cpu().numpy()[:n]):
                raise SystemExit(f"bucket {b}, {n} requests: served actions "
                                 f"differ from policy_decision")
            want = logits.argmax(-1).cpu().numpy()
            top2 = torch.topk(logits, 2, -1).values.cpu().numpy()
            margin = top2[:, 0] - top2[:, 1]
            off = got != want
            if (off & (margin >= MARGIN)).any():
                raise SystemExit(f"bucket {b}, {n} requests: padding changed "
                                 f"an action with margin >= {MARGIN}")
            loose += int(off.sum())
            for _ in range(LATENCY_REPS):
                t0 = time.perf_counter()
                engine.decide(obs[rows], mask[rows])
                lat.append((time.perf_counter() - t0) * 1e3)
        latency[str(bucket)] = {
            "sizes": list(sizes), "samples": len(lat),
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}
    _line("requests", pool_rows=int(obs.shape[0]), warmed=list(warmed),
          dtype="bfloat16", decide_latency=latency,
          unpadded_mismatches_below_margin=loose)
    return latency


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter()


def _device_account(torch, fn):
    """Run ``fn`` under ``torch.profiler``; return (its result, device
    ops, device busy seconds, wall seconds)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = _sync(torch)
        out = fn()
        wall = _sync(torch) - t0
    ops = [e for e in prof.events() if e.device_type.name == "CUDA"]
    return out, len(ops), sum(e.time_range.elapsed_us() for e in ops) / 1e6, \
        wall


def train_phase(torch, dev):
    """Config 2 at its published training geometry (phase 5)."""
    from rlgpuschedule_tpu_torch.algos.ppo import (PPOMetrics,
                                                   compute_advantages,
                                                   run_ppo_epochs)
    from rlgpuschedule_tpu_torch.algos.rollout import rollout
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.experiment import Experiment

    cfg = CONFIGS[CONFIG]
    ppo = cfg.ppo
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    exp = Experiment.build(cfg, device=dev)
    warm = exp.run(1, log_every=1)

    def stages():
        t0 = _sync(torch)
        exp.carry, tr, last = rollout(exp.net, exp.env_params, exp.traces,
                                      exp.carry, ppo.n_steps)
        t1 = _sync(torch)
        _, adv, ret, _ = compute_advantages(ppo, exp.train_state, tr,
                                            last)
        t2 = _sync(torch)
        exp.train_state, m = run_ppo_epochs(ppo, exp.train_state, tr, adv,
                                            ret, generator=exp.generator)
        t3 = _sync(torch)
        return m, (t1 - t0, t2 - t1, t3 - t2)

    split, metrics = [], []
    for _ in range(TRAIN_TIMED):
        m, s = stages()
        split.append(s)
        metrics.append(dict(zip(PPOMetrics._fields,
                                torch.stack(m).tolist())))
    wall = sum(sum(s) for s in split)
    sps = TRAIN_TIMED * exp.steps_per_iteration / wall

    # one more iteration, each stage under the profiler
    n_mb = ppo.n_epochs * ppo.n_minibatches
    acct = {}
    (_, tr, last), ops, busy, w = _device_account(
        torch, lambda: rollout(exp.net, exp.env_params, exp.traces,
                               exp.carry, ppo.n_steps))
    acct["rollout"] = (ops, busy, w, ppo.n_steps)
    (adv, ret), ops, busy, w = _device_account(
        torch, lambda: compute_advantages(ppo, exp.train_state, tr,
                                          last)[1:3])
    acct["gae"] = (ops, busy, w, 1)
    (exp.train_state, _), ops, busy, w = _device_account(
        torch, lambda: run_ppo_epochs(ppo, exp.train_state, tr, adv, ret,
                                      generator=exp.generator))
    acct["update"] = (ops, busy, w, n_mb)
    busy_all = sum(a[1] for a in acct.values())
    wall_prof = sum(a[2] for a in acct.values())
    if cuda:
        # the loop body waits for the card nowhere: one more iteration
        # with torch raising on any synchronizing call
        torch.cuda.set_sync_debug_mode("error")
        try:
            exp.train_state, exp.carry, _ = exp.train_step(
                exp.train_state, exp.carry, exp.traces, exp.generator)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    peak = torch.cuda.max_memory_allocated() if cuda else None
    # the precision of the timed path: f32 parameters, grads and Adam
    # moments; the trunk computing in bf16
    opt = exp.train_state.opt
    all_f32 = all(p.dtype == p.grad.dtype == opt.state[p]["exp_avg"].dtype
                  == opt.state[p]["exp_avg_sq"].dtype == torch.float32
                  for p in exp.train_state.net.parameters())
    with torch.no_grad():
        trunk = exp.train_state.net.encoder(tr.obs[0]).dtype
    _line("train", config=cfg.name, dtype="bfloat16", n_envs=cfg.n_envs,
          n_steps=ppo.n_steps, n_epochs=ppo.n_epochs,
          n_minibatches=ppo.n_minibatches,
          minibatch=ppo.n_steps * cfg.n_envs // ppo.n_minibatches,
          params=sum(p.numel() for p in exp.net.parameters()),
          warmup_s=warm["wall_s"],
          iteration_split_s=[{"rollout": a, "gae_norm": b, "update": c}
                             for a, b, c in split],
          env_steps_per_s=sps,
          profiled={k: {"device_ops": o, "device_busy_s": b, "wall_s": w,
                        "per": n, "ops_per": o / n, "busy_ms_per": b / n
                        * 1e3}
                    for k, (o, b, w, n) in acct.items()},
          device_idle_share=1.0 - busy_all / wall_prof,
          device_idle_share_unprofiled=1.0 - busy_all / (wall
                                                         / TRAIN_TIMED),
          iteration_without_host_sync=cuda, peak_memory_bytes=peak,
          params_grads_adam_moments_f32=all_f32, trunk_output=str(trunk),
          metrics=metrics)
    if not (all_f32 and trunk == torch.bfloat16):
        raise SystemExit(f"training precision: parameters, grads and Adam "
                         f"moments f32: {all_f32}; trunk output {trunk}")
    for m in metrics:
        if not _finite(m["total_loss"], m["entropy"], m["approx_kl"]):
            raise SystemExit(f"non-finite training metrics: {m}")
    if not acct["update"][0]:
        raise SystemExit("the profiler saw no kernel in the update")
    return exp


def _bench_config():
    """Config 1 at ``bench.py``'s chip geometry."""
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    base = CONFIGS[BENCH_CONFIG]
    g = BENCH_GEOMETRY
    return dataclasses.replace(
        base, n_envs=g["n_envs"],
        ppo=dataclasses.replace(base.ppo, n_steps=g["n_steps"],
                                n_epochs=g["n_epochs"],
                                n_minibatches=g["n_minibatches"]))


def bench_phase(torch, dev):
    """Config 1 at bench.py's chip geometry (phase 6)."""
    from rlgpuschedule_tpu_torch.experiment import Experiment

    cfg = _bench_config()
    exp = Experiment.build(cfg, device=dev)
    exp.run(1)
    out = exp.run(TRAIN_TIMED, log_every=1)
    last = out["history"][-1]
    _line("bench", config=cfg.name, dtype="bfloat16", n_envs=cfg.n_envs,
          n_steps=cfg.ppo.n_steps, n_epochs=cfg.ppo.n_epochs,
          n_minibatches=cfg.ppo.n_minibatches, iterations=TRAIN_TIMED,
          wall_s=out["wall_s"], env_steps=out["env_steps"],
          env_steps_per_s=out["env_steps_per_sec"], last_iteration=last)
    if not _finite(out["env_steps_per_sec"], last["total_loss"],
                   last["entropy"]):
        raise SystemExit("config-1 training reported a non-finite value")


def train_compare_phase(torch, dev):
    """Card against CPU at f32 on config 2's training path (phase 7)."""
    from rlgpuschedule_tpu_torch.algos import action_dist
    from rlgpuschedule_tpu_torch.algos.ppo import (make_learn_step,
                                                   make_train_state)
    from rlgpuschedule_tpu_torch.algos.rollout import init_carry, rollout
    from rlgpuschedule_tpu_torch.algos.update import tree_map
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.env import stack_traces
    from rlgpuschedule_tpu_torch.experiment import (build_env_params,
                                                    load_source_trace,
                                                    make_env_windows)
    from rlgpuschedule_tpu_torch.models import make_policy
    from rlgpuschedule_tpu_torch.sim.core import validate_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg = CONFIGS[CONFIG]
    ppo = cfg.ppo
    env_params = build_env_params(cfg)
    windows = make_env_windows(cfg, validate_trace(
        env_params.sim, load_source_trace(cfg), clamp=True))
    side = {}
    for d in (dev, "cpu"):
        net = make_policy(cfg.obs_kind, env_params.n_actions,
                          env_params.obs_shape(), dtype=torch.float32,
                          seed=cfg.seed, device=d)
        side[d] = (net, stack_traces(windows, env_params, d))

    net, traces = side[dev]
    carry = init_carry(env_params, traces,
                       torch.Generator(dev).manual_seed(cfg.seed))
    _, tr, last = rollout(net, env_params, traces, carry, ppo.n_steps)
    tr = tree_map(lambda x: x.cpu(), tr)
    last = last.cpu()

    actions = iter(tr.action[:REPLAY_STEPS])

    def replay(gen, logits):
        a = next(actions)
        return a, action_dist.log_prob(logits, a)

    net_c, traces_c = side["cpu"]
    carry_c = init_carry(env_params, traces_c, torch.Generator())
    _, tr_c, _ = rollout(net_c, env_params, traces_c, carry_c, REPLAY_STEPS,
                         sample_fn=replay)
    differ = {f: int((getattr(tr, f)[:REPLAY_STEPS]
                      != getattr(tr_c, f)).sum())
              for f in ("obs", "mask", "reward", "done", "env_steps_dt")}
    lp_err = float((tr.log_prob[:REPLAY_STEPS] - tr_c.log_prob).abs().max())
    v_err = float((tr.value[:REPLAY_STEPS] - tr_c.value).abs().max())
    # why the observations take tanh in f64: f32 tanh on both devices
    # over the observations' input range, and the f64-rounded form
    x = torch.cat([torch.arange(2**20) / 600.0,
                   torch.rand(2**22, generator=torch.Generator()
                              .manual_seed(0)) * 20])
    tanh_differ = {
        "f32": int((torch.tanh(x) != torch.tanh(x.to(dev)).cpu()).sum()),
        "f64_rounded": int((torch.tanh(x.double()).float()
                            != torch.tanh(x.to(dev).double()).float().cpu())
                           .sum())}

    B = ppo.n_steps * cfg.n_envs
    gen = torch.Generator().manual_seed(cfg.seed)
    perms = [torch.randperm(B, generator=gen) for _ in range(ppo.n_epochs)]
    learn = make_learn_step(ppo)
    out = {}
    for d in (dev, "cpu"):
        state = make_train_state(side[d][0], ppo)
        batch = tree_map(lambda x: x.to(d), tr)
        state, m = learn(state, batch, last.to(d), perms=perms)
        out[d] = ({n: p.detach().cpu() for n, p in
                   state.net.named_parameters()},
                  {k: float(v) for k, v in m._asdict().items()})
    (pg, mg), (pc, mc) = out[dev], out["cpu"]
    param_err = max(float((pg[n] - pc[n]).abs().max()) for n in pc)
    metric_rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30)
                  for k in mc}
    _line("train_card_vs_cpu", config=cfg.name, dtype="float32", tf32=False,
          cudnn_deterministic=True, clusters=cfg.n_envs,
          replay_steps=REPLAY_STEPS, replay_elements_differing=differ,
          replay_log_prob_max_abs_diff=lp_err,
          replay_value_max_abs_diff=v_err,
          tanh_probe_inputs=x.numel(), tanh_elements_differing=tanh_differ,
          learn_batch=B,
          learn_param_max_abs_diff=param_err,
          learn_metric_max_rel_diff=max(metric_rel.values()),
          metrics_card=mg, metrics_cpu=mc)
    if any(differ.values()):
        raise SystemExit(f"card and CPU rollouts differ: {differ}")
    if not param_err <= PARAM_ATOL:
        raise SystemExit(f"learn step: parameters differ by {param_err} "
                         f"(> {PARAM_ATOL}) between the card and the CPU")
    # the CPU parity tests' metric tolerance: rtol 1e-4, atol 1e-6
    bad = {k: (mg[k], mc[k]) for k in mc
           if not abs(mg[k] - mc[k]) <= METRIC_ATOL + METRIC_RTOL * abs(mc[k])}
    if bad:
        raise SystemExit(f"learn step: metrics (card, CPU) differ beyond "
                         f"rtol {METRIC_RTOL} / atol {METRIC_ATOL}: {bad}")


def eval_phase(torch, dev, trained):
    """Config 2's JCT table on held-out windows (phase 8); returns the
    windows. ``trained`` is phase 5's experiment."""
    from rlgpuschedule_tpu_torch import native
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.env import stack_traces
    from rlgpuschedule_tpu_torch.eval import format_report, jct_report, replay
    from rlgpuschedule_tpu_torch.experiment import (Experiment,
                                                    load_source_trace,
                                                    make_env_windows)
    from rlgpuschedule_tpu_torch.sim.core import validate_trace

    # the native engine is compiled on first use (g++, into the user
    # cache); a failed build raises here
    t0 = time.perf_counter()
    if not native.available():
        raise SystemExit(f"native engine unavailable: "
                         f"{native.build_error()}")
    build_s = time.perf_counter() - t0
    cfg = CONFIGS[CONFIG]
    exp = Experiment.build(cfg, device=dev)
    held = dataclasses.replace(cfg, seed=cfg.seed + 1000,
                               n_envs=EVAL_WINDOWS, source_jobs=None)
    windows = make_env_windows(held, validate_trace(
        exp.env_params.sim, load_source_trace(held), clamp=True))
    # first-call costs (allocator, cuDNN at this batch) outside the table
    jct_report(exp, windows=windows, max_steps=4, include_random=False,
               baselines=())
    # the replay loop waits for the card nowhere but at its every-64-steps
    # "all done?" check: 63 steps of the gated greedy and of the random
    # replay with torch raising on any synchronizing call
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        traces = stack_traces(windows, exp.env_params, dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            replay(exp.net, exp.env_params, traces, 63, backlog_gate=GATE)
            replay(None, exp.env_params, traces, 63, policy="random",
                   generator=torch.Generator(dev).manual_seed(1))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        del traces
    report = jct_report(exp, windows=windows, max_steps=EVAL_STEPS,
                        percentiles=PERCENTILES, backend="native")
    print(format_report(report), file=sys.stderr, flush=True)
    pcts = report["percentiles"]
    for row in ROWS:
        _line("eval_row", row=row, avg_jct=report[row], **pcts[row])
    wall = report["wall_s"]
    _line("eval_table", config=cfg.name, weights="seeded init (bf16)",
          windows=len(windows), jobs_per_window=cfg.window_jobs,
          gpus=cfg.total_gpus, held_out_seed=held.seed,
          max_steps=EVAL_STEPS,
          policy_completion=report["policy_completion"],
          policy_utilization=report["policy_utilization"],
          vs_tiresias=report["vs_tiresias"],
          baseline_backend=report["baseline_backend"],
          native_build_or_load_s=build_s,
          wall_s=wall, replay_loop_without_host_sync=cuda,
          policy_steps=report["policy_steps"],
          policy_decisions_per_s=report["policy_steps"]
          / wall["policy_replay"],
          baseline_s_per_window=wall["baselines"] / len(windows))
    values = [report[k] for k in ROWS + ("policy_completion",
                                         "vs_tiresias")]
    values += [v for row in pcts.values() for v in row.values()]
    values += list(wall.values())
    if not _finite(*values):
        raise SystemExit(f"the JCT table has a non-finite value: {report}")
    if not report["policy_completion"] > 0:
        raise SystemExit("the policy completed no job in the JCT table")
    if report["baseline_backend"] != "native":
        raise SystemExit("the baselines did not run on the native engine")

    # the policy phase 5 trained, on the same windows
    tr = jct_report(trained, windows=windows, max_steps=EVAL_STEPS,
                    include_random=False, baselines=("tiresias",),
                    backend="native")
    _line("eval_trained",
          weights=f"after phase 5 ({TRAIN_TIMED + 3} PPO iterations)",
          policy=tr["policy"], policy_completion=tr["policy_completion"],
          vs_tiresias=tr["vs_tiresias"], policy_steps=tr["policy_steps"],
          wall_s=tr["wall_s"])
    if not _finite(tr["policy"], tr["policy_completion"],
                   tr["vs_tiresias"]):
        raise SystemExit(f"the trained policy's row is not finite: {tr}")
    return windows


def _first_split(acts_a, acts_b, margin, steps):
    """Per window: None if the actions agree over ``steps``, else (step,
    the CPU's margin there)."""
    out = []
    for e in range(acts_a.shape[1]):
        n = int(steps[e])
        diff = (acts_a[:n, e] != acts_b[:n, e]).nonzero().flatten()
        out.append(None if not diff.numel() else
                   (int(diff[0]), float(margin[int(diff[0]), e])))
    return out


def _window_jcts(torch, states, traces, e):
    """Per-job JCTs of window ``e``'s completed jobs, in f64."""
    finish = states.sim.finish[e].cpu().double()
    done = traces.valid[e].cpu() & torch.isfinite(finish)
    return (finish[done] - traces.submit[e].cpu().double()[done]).tolist()


def eval_compare_phase(torch, dev, windows):
    """Card against CPU and native against Python on the held-out
    windows (phase 9)."""
    import numpy as np

    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.env import stack_traces
    from rlgpuschedule_tpu_torch.eval import pooled_avg_jct, replay
    from rlgpuschedule_tpu_torch.experiment import build_env_params
    from rlgpuschedule_tpu_torch.models import make_policy
    from rlgpuschedule_tpu_torch.sim.schedulers import run_baseline
    from rlgpuschedule_tpu_torch.traces import gen_poisson_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = CONFIGS[CONFIG]
    env_params = build_env_params(cfg)
    sub = windows[:EVAL_COMPARE]
    out = {}
    for side in (dev, "cpu"):
        net = make_policy(cfg.obs_kind, env_params.n_actions,
                          env_params.obs_shape(), dtype=torch.float32,
                          seed=cfg.seed, device=side)
        traces = stack_traces(sub, env_params, side)
        res, states, rec = replay(net, env_params, traces, EVAL_STEPS,
                                  record=True, return_states=True)
        gres, grec = replay(net, env_params, traces, EVAL_STEPS,
                            record=True, backlog_gate=GATE)
        out[side] = dict(
            res={k: v.cpu() for k, v in res._asdict().items()},
            acts=rec.actions.cpu(), margin=rec.margin.cpu(),
            jcts=[_window_jcts(torch, states, traces, e)
                  for e in range(EVAL_COMPARE)],
            row=pooled_avg_jct(res)[0],
            gsteps=gres.steps.cpu(), gacts=grec.actions.cpu(),
            gmargin=grec.margin.cpu())
    g, c = out[dev], out["cpu"]
    steps = torch.minimum(g["res"]["steps"], c["res"]["steps"])
    splits = _first_split(g["acts"], c["acts"], c["margin"], steps)
    gsteps = torch.minimum(g["gsteps"], c["gsteps"])
    gsplits = _first_split(g["gacts"], c["gacts"], c["gmargin"], gsteps)
    for what, sp in (("greedy", splits), ("backlog-gated", gsplits)):
        for e, cut in enumerate(sp):
            if cut is not None and cut[1] >= MARGIN:
                raise SystemExit(
                    f"window {e}: card and CPU {what} actions differ at "
                    f"step {cut[0]} where the CPU's margin is {cut[1]}")
    compared = [e for e, cut in enumerate(splits) if cut is None]
    for e in compared:
        for k in ("steps", "n_done"):
            if int(g["res"][k][e]) != int(c["res"][k][e]):
                raise SystemExit(f"window {e}: {k} differs between the "
                                 f"card and the CPU")
        if g["jcts"][e] != c["jcts"][e]:
            raise SystemExit(f"window {e}: per-job JCTs differ between the "
                             f"card and the CPU")
    row_rel = abs(g["row"] - c["row"]) / max(abs(c["row"]), 1e-30)
    if len(compared) == EVAL_COMPARE and row_rel > 1e-6:
        raise SystemExit(f"the policy row differs by {row_rel} (relative)")
    if not compared:
        raise SystemExit("no window was compared to the end")

    # native engine against the Python oracle: on the held-out windows,
    # where no job waits for GPUs and the four baselines tie, and on an
    # overloaded 2x8 cluster (tests/test_torch_oracle.py's trace), where
    # SRTF and Tiresias preempt and the rows part
    overloaded = gen_poisson_trace(0.05, 80, 0, mean_duration=2000.0)
    cases = [("held_out", cfg.n_nodes, cfg.gpus_per_node, w) for w in sub]
    cases.append(("overloaded", 2, 8, overloaded))
    secs = {"native": {}, "python": {}}
    worst = {"finish": 0.0, "start": 0.0, "avg_jct_rel": 0.0}
    overloaded_rows = {}
    for name in BASELINES:
        for b in secs:
            secs[b][name] = 0.0
        for what, n_nodes, gpn, w in cases:
            runs = {}
            for b in secs:
                t0 = time.perf_counter()
                runs[b] = run_baseline(w, n_nodes, gpn, name, backend=b)
                if what == "held_out":
                    secs[b][name] += (time.perf_counter() - t0) / len(sub)
            nat, py = runs["native"], runs["python"]
            for f in ("finish", "start"):
                a = np.where(np.isnan(getattr(nat, f)), np.inf,
                             getattr(nat, f))[w.valid]
                b = np.where(np.isnan(getattr(py, f)), np.inf,
                             getattr(py, f))[w.valid]
                same_inf = np.isinf(a) == np.isinf(b)
                err = float(np.abs(a - b)[np.isfinite(a)].max(initial=0))
                if not same_inf.all() or err > 1e-6:
                    raise SystemExit(f"{name} ({what}): native and Python "
                                     f"{f} times differ by {err}")
                worst[f] = max(worst[f], err)
            if not np.array_equal(nat.status, py.status):
                raise SystemExit(f"{name} ({what}): native and Python "
                                 f"status differ")
            rel = abs(nat.avg_jct() - py.avg_jct()) / abs(py.avg_jct())
            if rel > 1e-9:
                raise SystemExit(f"{name} ({what}): avg JCT differs by "
                                 f"{rel}")
            worst["avg_jct_rel"] = max(worst["avg_jct_rel"], rel)
            if what == "overloaded":
                overloaded_rows[name] = nat.avg_jct()
    if len(set(overloaded_rows.values())) < 2:
        raise SystemExit(f"the overloaded trace did not part the baselines: "
                         f"{overloaded_rows}")
    _line("eval_card_vs_cpu", config=cfg.name, windows=EVAL_COMPARE,
          dtype="float32", tf32=False, compared_to_end=len(compared),
          cut_short={str(e): {"step": s, "cpu_margin": m}
                     for e, cut in enumerate(splits) if cut
                     for s, m in [cut]},
          steps=[int(x) for x in c["res"]["steps"]],
          n_done=[int(x) for x in c["res"]["n_done"]],
          policy_row_card=g["row"], policy_row_cpu=c["row"],
          policy_row_rel_diff=row_rel,
          gated_cut_short={str(e): {"step": s, "cpu_margin": m}
                           for e, cut in enumerate(gsplits) if cut
                           for s, m in [cut]},
          gated_steps=[int(x) for x in c["gsteps"]],
          native_vs_python_max_diff=worst,
          native_vs_python_cases={"held_out_windows": len(sub),
                                  "overloaded_2x8_windows": 1},
          overloaded_avg_jct=overloaded_rows,
          baseline_s_per_window=secs)


def _spawn(module: str, args: list[str], env: "dict | None" = None):
    """``python -m <module> <args>`` from the checkout, started and not
    waited for (:func:`_reap_all` collects it), with ``env`` added to
    this process's environment. Its stdout and stderr go to unnamed
    temporary files, never to pipes: a child whose pipe nobody reads
    would block once it filled."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    p = subprocess.Popen([sys.executable, "-m", module, *args], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root, **(env or {})),
                         stdout=out, stderr=err, text=True)
    return p, out, err, time.perf_counter()


def _reap_all(children: dict, timeout: int = 600) -> dict:
    """Wait for :func:`_spawn`-ed CLIs, each at most ``timeout`` s from
    its start (past that every one is killed); per child its JSON lines,
    stderr and wall from start to exit (polled every 50 ms). Fatal if
    one fails."""
    walls = {}
    while len(walls) < len(children):
        for k, (p, _, _, t0) in children.items():
            if k not in walls and p.poll() is not None:
                walls[k] = time.perf_counter() - t0
            elif k not in walls and time.perf_counter() - t0 > timeout:
                _kill(children)
                raise SystemExit(f"python -m {p.args[2]} ran past "
                                 f"{timeout} s")
        time.sleep(0.05)
    done = {}
    for k, (p, out, err, _) in children.items():
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
        out.close()
        err.close()
        if p.returncode != 0:
            print(stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"python -m {p.args[2]} exited {p.returncode}")
        done[k] = ([json.loads(x) for x in stdout.splitlines()
                    if x.startswith("{")], stderr, walls[k])
    return done


def _kill(children: dict) -> None:
    """Kill and wait for every :func:`_spawn`-ed CLI still running."""
    for p, *_ in children.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _run_main(module: str, args: list[str]):
    """``<module>.main(args)`` in this process: the CLI as ``python -m
    <module>`` runs it but without a new interpreter's start and card
    setup (10-20 s each), under torch's default cuDNN/TF32 switches as a
    new process has them (earlier phases change them); its JSON lines,
    what ``main`` returned and its wall. Fatal if ``main`` returns a
    nonzero exit code."""
    import importlib
    import io

    import torch
    out = io.StringIO()
    old = _flags(torch, tf32=True, deterministic=False)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            ret = importlib.import_module(module).main(args)
    finally:
        _restore_flags(torch, old)
    wall = time.perf_counter() - t0
    if isinstance(ret, int) and ret:
        print(out.getvalue()[-4000:], file=sys.stderr)
        raise SystemExit(f"{module}.main{tuple(args)} returned {ret}")
    lines = [json.loads(x) for x in out.getvalue().splitlines()
             if x.startswith("{")]
    return lines, ret, wall


def entry_point_phase(torch, dev):
    """The evaluate and train CLIs on the card (phase 10)."""
    lines, _, wall = _run_main(
        "rlgpuschedule_tpu_torch.evaluate",
        ["--config", CONFIG, "--eval-windows", "4", "--max-steps",
         str(EVAL_STEPS), "--percentiles"])
    (line,) = lines
    _line("evaluate_cli", wall_s=wall, report=line)
    if not (line["device"].startswith("cuda") and
            _finite(line["policy"], line["vs_tiresias"],
                    line["policy_completion"])):
        raise SystemExit(f"evaluate CLI: {line}")
    lines, _, wall = _run_main(
        "rlgpuschedule_tpu_torch.train",
        ["--config", BENCH_CONFIG, "--iterations", "4", "--eval-every", "2",
         "--report"])
    probes = [r for r in lines if "eval_vs_tiresias" in r]
    summary = lines[-1]
    _line("train_cli", wall_s=wall, probes=probes,
          jct_report=summary.get("jct_report"),
          env_steps_per_s=summary.get("env_steps_per_sec"),
          device=summary.get("device"))
    if [r["iteration"] for r in probes] != [1, 3]:
        raise SystemExit(f"train CLI: probe rows {probes}")
    rep = summary.get("jct_report") or {}
    if not (summary.get("device", "").startswith("cuda")
            and _finite(rep.get("policy", math.nan),
                        rep.get("vs_tiresias", math.nan),
                        *(r["eval_vs_tiresias"] for r in probes))):
        raise SystemExit(f"train CLI: summary {summary}")


def _integer_windows(windows):
    """The windows with integer submit times and durations (exact in
    f32, where the card and the CPU must agree bit for bit)."""
    import numpy as np
    return [dataclasses.replace(
        w, submit=np.where(w.valid, np.round(w.submit),
                           np.inf).astype(np.float32),
        duration=np.maximum(np.round(w.duration), 1.0).astype(np.float32))
        for w in windows]


def _feed(torch, env_params, windows, dev, seed):
    """A host-drawn masked-uniform action sequence through ``env.step``
    on the card and on the CPU: the sim state, mask and reward must be
    bit-identical at every step. Returns the spread placements and the
    preemptions the feed made, and the observation elements that differ
    (reported, not required to be zero)."""
    import numpy as np

    from rlgpuschedule_tpu_torch.env import env as env_lib
    from rlgpuschedule_tpu_torch.env import stack_traces

    sim = env_params.sim
    kp, P = sim.queue_len * sim.n_placements, sim.n_placements
    sides = {}
    for d in (dev, "cpu"):
        traces = stack_traces(windows, env_params, d)
        sides[d] = [traces, *env_lib.reset(env_params, traces)]
    rng = np.random.default_rng(seed)
    spread = preempted = obs_differ = 0
    with torch.inference_mode():
        for i in range(FEED_STEPS):
            mask = sides["cpu"][2].action_mask.numpy()
            a = np.array([rng.choice(np.flatnonzero(r)) for r in mask],
                         np.int64)
            for d, (traces, state, _) in sides.items():
                state, ts = env_lib.step(env_params, state, traces,
                                         torch.from_numpy(a).to(d))
                sides[d][1:] = [state, ts]
            (_, sg, tg), (_, sc, tc) = sides[dev], sides["cpu"]
            pairs = [(f"sim.{f}", getattr(sg.sim, f), getattr(sc.sim, f))
                     for f in sc.sim._fields]
            pairs += [("mask", tg.action_mask, tc.action_mask),
                      ("reward", tg.reward, tc.reward),
                      ("done", tg.done, tc.done)]
            for name, x, y in pairs:
                x = x.cpu()
                if not (x.dtype == y.dtype
                        and x.numpy().tobytes() == y.numpy().tobytes()):
                    raise SystemExit(f"action feed: {name} differs between "
                                     f"the card and the CPU at step {i}")
            obs_differ += int((tg.obs.cpu().view(torch.int32)
                               != tc.obs.view(torch.int32)).sum())
            placed = tc.info.placed.numpy()
            spread += int((placed & (a < kp) & (a % P == 1)).sum()) \
                if P > 1 else 0
            preempted += int(tc.info.preempted.sum())
    return spread, preempted, obs_differ


def _cycling_policy(torch, cfg, env_params, dev):
    """The seeded preempt policy with +20 on preempting running slot 0
    and +10 on placing queue slot 0: place<->preempt is its argmax
    whenever both are legal, so only the stall guard ends the cycle."""
    from rlgpuschedule_tpu_torch.experiment import build_policy

    policy = build_policy(cfg, env_params, device=dev)
    kp = cfg.queue_len * cfg.n_placements
    with torch.no_grad():
        policy.policy.bias[kp] += 20.0
        policy.policy.bias[0] += 10.0
    return policy


def action_space_phase(torch, dev):
    """The preemptive and pack|spread action spaces on the card
    (phase 11)."""
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.eval import replay
    from rlgpuschedule_tpu_torch.experiment import build_env_params
    from rlgpuschedule_tpu_torch.serve.fleet import (fleet_replay,
                                                     fleet_windows)

    totals = {"spread_placements": 0, "preemptions": 0,
              "stall_gate_engagements": 0}
    for name in NEW_PRESETS:
        cfg = dataclasses.replace(CONFIGS[name], horizon=NEW_HORIZON)
        env_params = build_env_params(cfg)
        t0 = time.perf_counter()
        windows, traces = fleet_windows(cfg, N_CLUSTERS, device=dev)
        policy = fleet_phase(torch, cfg, env_params, traces, dev)
        # phase 2's method over a shorter window (the profiler's own
        # processing of the events is most of its cost)
        prof = _replay_profile(torch, env_params, traces, policy,
                               *SHORT_PROFILE)
        _line("new_profile", config=name,
              fleet_and_profile_wall_s=time.perf_counter() - t0,
              **{k: prof[k] for k in (
                  "launches_per_step", "device_busy_s", "step_ms_unprofiled",
                  "device_idle_share_unprofiled", "policy_forward_ms",
                  "top_device_ops")})
        del policy, traces
        # card against CPU at the preset's own horizon
        t0 = time.perf_counter()
        compare_phase(torch, CONFIGS[name], build_env_params(CONFIGS[name]),
                      windows, dev)
        t1 = time.perf_counter()
        spread, pre, obs_differ = _feed(
            torch, env_params, _integer_windows(windows[:FEED_CLUSTERS]),
            dev, cfg.seed)
        totals["spread_placements"] += spread
        totals["preemptions"] += pre
        _line("action_feed", config=name, clusters=FEED_CLUSTERS,
              steps=FEED_STEPS, state_mask_reward_bit_identical=True,
              obs_elements_differing=obs_differ, spread_placements=spread,
              preemptions=pre, compare_wall_s=t1 - t0,
              feed_wall_s=time.perf_counter() - t1)
        if not cfg.preempt_len:
            continue
        # the cycling policy: the guard must end every cycle
        ccfg = dataclasses.replace(cfg, window_jobs=CYCLE_JOBS,
                                   horizon=CYCLE_STEPS)
        long = build_env_params(ccfg)
        cyc = _cycling_policy(torch, ccfg, long, dev)
        _, sub = fleet_windows(ccfg, CYCLE_CLUSTERS, device=dev)
        t0 = _sync(torch)
        res, rec = replay(cyc, long, sub, record=True)
        wall = _sync(torch) - t0
        open_ = replay(cyc, long, sub, UNGUARDED_STEPS, stall_guard=False)
        gated = int(rec.gated.sum())
        totals["stall_gate_engagements"] += gated
        done, valid = int(res.n_done.sum()), int(res.n_valid.sum())
        open_done = int(open_.n_done.sum())
        _line("stall_guard", config=name, clusters=CYCLE_CLUSTERS,
              jobs_per_window=CYCLE_JOBS,
              guarded_steps=[int(x) for x in res.steps],
              guarded_completion=done / valid, gate_engagements=gated,
              preempts_taken=int((rec.actions == cfg.queue_len
                                  * cfg.n_placements).sum()),
              guarded_wall_s=wall, unguarded_steps=UNGUARDED_STEPS,
              unguarded_done=open_done)
        if done != valid:
            raise SystemExit(f"{name}: with the stall guard the cycling "
                             f"policy finished {done} of {valid} jobs")
        if open_done:
            raise SystemExit(f"{name}: without the stall guard the cycling "
                             f"policy still finished {open_done} jobs")
    _line("action_space_totals", **totals)
    zero = [k for k, v in totals.items() if not v]
    if zero:
        raise SystemExit(f"phase 11 never exercised: {zero}")


def preset_train_eval_phase(torch, dev):
    """Training and evaluation of both new presets (phase 12)."""
    from rlgpuschedule_tpu_torch.algos.ppo import (PPOMetrics,
                                                   compute_advantages,
                                                   make_learn_step,
                                                   make_train_state,
                                                   run_ppo_epochs)
    from rlgpuschedule_tpu_torch.algos.rollout import init_carry, rollout
    from rlgpuschedule_tpu_torch.algos.update import tree_map
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.eval import format_report, jct_report
    from rlgpuschedule_tpu_torch.experiment import (Experiment,
                                                    build_policy,
                                                    load_source_trace,
                                                    make_env_windows)
    from rlgpuschedule_tpu_torch.sim.core import validate_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    for name in NEW_PRESETS:
        cfg = CONFIGS[name]
        ppo = cfg.ppo
        exp = Experiment.build(cfg, device=dev)
        exp.run(1)
        split, metrics = [], []
        for _ in range(TRAIN_TIMED):
            t0 = _sync(torch)
            exp.carry, tr, last = rollout(exp.net, exp.env_params,
                                          exp.traces, exp.carry, ppo.n_steps)
            t1 = _sync(torch)
            _, adv, ret, _ = compute_advantages(ppo, exp.train_state, tr,
                                            last)
            t2 = _sync(torch)
            exp.train_state, m = run_ppo_epochs(
                ppo, exp.train_state, tr, adv, ret, generator=exp.generator)
            t3 = _sync(torch)
            split.append({"rollout": t1 - t0, "gae_norm": t2 - t1,
                          "update": t3 - t2})
            metrics.append(dict(zip(PPOMetrics._fields,
                                    torch.stack(m).tolist())))
        wall = sum(sum(x.values()) for x in split)
        _line("new_train", config=name, dtype="bfloat16", n_envs=cfg.n_envs,
              n_steps=ppo.n_steps, n_epochs=ppo.n_epochs,
              n_minibatches=ppo.n_minibatches,
              params=sum(p.numel() for p in exp.net.parameters()),
              iteration_split_s=split,
              env_steps_per_s=TRAIN_TIMED * exp.steps_per_iteration / wall,
              metrics=metrics)
        for m in metrics:
            if not _finite(m["total_loss"], m["entropy"], m["approx_kl"]):
                raise SystemExit(f"{name}: non-finite training metrics {m}")

        # one learn step, card against CPU at f32
        side = {}
        for d in (dev, "cpu"):
            side[d] = build_policy(cfg, exp.env_params, dtype=torch.float32,
                                   device=d)
        carry = init_carry(exp.env_params, exp.traces,
                           torch.Generator(dev).manual_seed(cfg.seed))
        _, tr, last = rollout(side[dev], exp.env_params, exp.traces, carry,
                              ppo.n_steps)
        tr, last = tree_map(lambda x: x.cpu(), tr), last.cpu()
        B = ppo.n_steps * cfg.n_envs
        gen = torch.Generator().manual_seed(cfg.seed)
        perms = [torch.randperm(B, generator=gen)
                 for _ in range(ppo.n_epochs)]
        learn = make_learn_step(ppo)
        out = {}
        for d in (dev, "cpu"):
            state, m = learn(make_train_state(side[d], ppo),
                             tree_map(lambda x: x.to(d), tr), last.to(d),
                             perms=perms)
            out[d] = ({n: p.detach().cpu()
                       for n, p in state.net.named_parameters()},
                      {k: float(v) for k, v in m._asdict().items()})
        (pg, mg), (pc, mc) = out[dev], out["cpu"]
        err = max(float((pg[n] - pc[n]).abs().max()) for n in pc)
        bad = {k: (mg[k], mc[k]) for k in mc if not abs(mg[k] - mc[k])
               <= METRIC_ATOL + METRIC_RTOL * abs(mc[k])}
        _line("new_learn_card_vs_cpu", config=name, dtype="float32",
              tf32=False, learn_batch=B, learn_param_max_abs_diff=err,
              metrics_card=mg, metrics_cpu=mc)
        if not err <= PARAM_ATOL or bad:
            raise SystemExit(f"{name}: learn step card vs CPU: parameters "
                             f"{err} (atol {PARAM_ATOL}), metrics {bad}")

        # the JCT table on held-out windows, with the trained policy
        held = dataclasses.replace(cfg, seed=cfg.seed + 1000,
                                   n_envs=NEW_EVAL_WINDOWS, source_jobs=None)
        windows = make_env_windows(held, validate_trace(
            exp.env_params.sim, load_source_trace(held), clamp=True))
        report = jct_report(exp, windows=windows, backend="native")
        print(format_report(report), file=sys.stderr, flush=True)
        rows = {k: report[k] for k in ROWS}
        _line("new_eval", config=name, windows=len(windows),
              weights=f"after {TRAIN_TIMED + 1} PPO iterations (bf16)",
              rows=rows, policy_completion=report["policy_completion"],
              vs_tiresias=report["vs_tiresias"],
              stall_guard=report.get("stall_guard"),
              policy_steps=report["policy_steps"], wall_s=report["wall_s"])
        if not _finite(*rows.values(), report["vs_tiresias"],
                       report["policy_completion"]):
            raise SystemExit(f"{name}: non-finite JCT table {report}")
        if (report.get("stall_guard") is True) != bool(cfg.preempt_len):
            raise SystemExit(f"{name}: stall_guard marker "
                             f"{report.get('stall_guard')}")
        del exp

    lines, err, wall = _run_main(
        "rlgpuschedule_tpu_torch.evaluate",
        ["--config", "gnn-gang-place", "--percentiles"])
    (line,) = lines
    _line("new_evaluate_cli", wall_s=wall, report=line)
    if not (line["device"].startswith("cuda") and
            _finite(line["policy"], line["vs_tiresias"],
                    line["policy_completion"])):
        raise SystemExit(f"evaluate CLI (gnn-gang-place): {line}")


def _against_eager(torch, engine, obs, mask, stall=None, gate=None):
    """``engine.decide`` on one request batch against the eager rule on
    the same padded batch (with ``stall``, gated by ``gate`` = (stall
    threshold, device preempt slice)): the served actions, the rows that
    differ and the rows whose top-two margin is below ``MARGIN``. A
    differing row above the margin is fatal: replaying inside a graph
    may let cuBLAS pick other algorithms than it does eagerly, so
    bit-identity is not the rule."""
    import numpy as np

    from rlgpuschedule_tpu_torch.decision import gate_stalled, greedy_actions
    from rlgpuschedule_tpu_torch.serve import pad_batch

    n = obs.shape[0]
    got, b = engine.decide(obs, mask, stall)
    dev = engine.device
    with torch.no_grad():
        o = torch.from_numpy(pad_batch(obs, b)).to(dev)
        m = torch.from_numpy(pad_batch(mask, b, True)).to(dev)
        if stall is not None:
            st = torch.from_numpy(pad_batch(stall.astype(np.int32), b))
            m = gate_stalled(m, st.to(dev), *gate)
        logits, _ = engine.policy(o, m)
        want = greedy_actions(logits).cpu().numpy()[:n]
        top2 = torch.topk(logits.float(), 2, -1).values.cpu().numpy()[:n]
    margin = top2[:, 0] - top2[:, 1]
    off = got != want
    if (off & (margin >= MARGIN)).any():
        raise SystemExit(f"{n} requests (bucket {b}): the graph's actions "
                         f"differ from eager at a margin >= {MARGIN}")
    return got, int(off.sum()), int((margin < MARGIN).sum())


class _GcPauses:
    """Garbage-collector pauses inside a ``with`` block: the count of
    full (generation-2) collections and the longest pause of any
    generation, from ``gc.callbacks``."""

    def __enter__(self):
        import gc
        self.full, self.max_s, self._t0 = 0, 0.0, 0.0

        def cb(phase, info):
            if phase == "start":
                self._t0 = time.perf_counter()
                return
            self.max_s = max(self.max_s, time.perf_counter() - self._t0)
            self.full += info["generation"] == 2
        self._cb = cb
        gc.callbacks.append(cb)
        return self

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._cb)

    def fields(self) -> dict:
        return {"gc_full_collections": self.full,
                "gc_max_pause_ms": self.max_s * 1e3}


def policy_server_phase(torch, dev, eager_latency):
    """Phase 13: the continuous-batching policy server on per-bucket CUDA
    graphs."""
    import numpy as np

    from rlgpuschedule_tpu_torch.analysis.sentinels import (
        CompileCounter, no_implicit_transfers)
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.decision import (preempt_slice,
                                                  stall_threshold)
    from rlgpuschedule_tpu_torch.experiment import (build_env_params,
                                                    build_policy)
    from rlgpuschedule_tpu_torch.obs import Registry
    from rlgpuschedule_tpu_torch.serve import (InferenceEngine,
                                               PolicyServer,
                                               build_request_pool,
                                               run_bench, run_host_path,
                                               run_soak)
    from rlgpuschedule_tpu_torch.serve.fleet import fleet_windows

    cfg = CONFIGS[CONFIG]
    env_params = build_env_params(cfg)
    policy = build_policy(cfg, env_params, device=dev)
    _, traces = fleet_windows(cfg, N_CLUSTERS, device=dev)
    sub = type(traces)(*(x[:64] for x in traces))
    pool = build_request_pool(policy, env_params, sub, steps=4)
    del traces, sub
    obs = np.stack([o for o, _ in pool])
    mask = np.stack([m for _, m in pool])

    # (1) one capture per bucket
    reg = Registry()
    engine = InferenceEngine(policy, max_bucket=256, device=dev,
                             registry=reg, strict=True)
    t0 = _sync(torch)
    with CompileCounter() as c:
        warmed = engine.warmup(obs[0], mask[0])
    capture_s = _sync(torch) - t0
    compiles = reg.counter("serve_bucket_compiles_total").value
    _line("serve_capture", graphs=engine.graphs, warmed=list(warmed),
          captures=c.captures, builds=c.builds, compiles_total=compiles,
          recompiles=engine.post_warmup_recompiles, wall_s=capture_s)
    if not (engine.graphs and c.captures == 9 and c.builds == 0
            and compiles == 9 and engine.post_warmup_recompiles == 0):
        raise SystemExit("warmup to bucket 256 must capture 9 graphs and "
                         "raise no recompile alarm")

    # (2) graph against eager, and the graph's decide latency
    served, differ, below, latency = {}, 0, 0, {}
    for bucket, sizes in BUCKETS.items():
        lat = []
        for n in sizes:
            rows = np.arange(n) * 7 % obs.shape[0]
            served[n], d, lo = _against_eager(torch, engine, obs[rows],
                                              mask[rows])
            differ, below = differ + d, below + lo
            for _ in range(LATENCY_REPS):
                t0 = time.perf_counter()
                engine.decide(obs[rows], mask[rows])
                lat.append((time.perf_counter() - t0) * 1e3)
        latency[str(bucket)] = {
            "graph_p50_ms": float(np.percentile(lat, 50)),
            "graph_p99_ms": float(np.percentile(lat, 99)),
            "eager_p50_ms": eager_latency[str(bucket)]["p50_ms"],
            "eager_p99_ms": eager_latency[str(bucket)]["p99_ms"]}
    _line("serve_graph_vs_eager", sizes=sorted(served),
          rows_differing_below_margin=differ, rows_below_margin=below,
          decide_latency=latency)

    # (3) the bench through the server
    server = PolicyServer(engine, registry=reg)
    with _GcPauses() as gcp:
        rep = run_bench(engine, server, pool, rounds=SERVE_ROUNDS,
                        request_sizes=SERVE_SIZES)
    errors = reg.counter("serve_dispatch_errors_total").value
    latency_max_ms = max(server._latencies) * 1e3
    server.close()
    _line("serve_bench", **gcp.fields(), latency_max_ms=latency_max_ms,
          requests=rep["requests"],
          dispatches=rep["dispatches"], buckets=rep["buckets"],
          latency_p50_ms=rep["latency_p50_ms"],
          latency_p99_ms=rep["latency_p99_ms"],
          decisions_per_s=rep["decisions_per_s"],
          batch_occupancy_mean=rep["batch_occupancy_mean"],
          post_warmup_recompiles=rep["post_warmup_recompiles"],
          dispatch_errors=errors, graphs=rep["graphs"])
    if rep["post_warmup_recompiles"] or errors:
        raise SystemExit(f"serve bench: {rep['post_warmup_recompiles']} "
                         f"recompiles, {errors} dispatch errors")

    # (4) the sync guard is live around a steady-state dispatch
    prog = next(p for k, p in engine._programs.items() if k[0] == 16)
    with no_implicit_transfers(dev):
        for d, h in zip(prog.inputs, prog.staging):
            d.copy_(h, non_blocking=True)
        prog.graph.replay()
    torch.cuda.synchronize()
    try:
        with no_implicit_transfers(dev):
            torch.ones(1, device=dev).sum().item()
    except RuntimeError as e:
        tripped = str(e).splitlines()[0]
    else:
        raise SystemExit("a .item() under the sync guard did not raise")
    _line("serve_sync_guard", steady_dispatch="ok", deliberate_item=tripped,
          mode_after=torch.cuda.get_sync_debug_mode())
    if torch.cuda.get_sync_debug_mode() != 0:
        raise SystemExit("the sync guard left its mode on")

    # (5) swap in other seeded weights, re-warm, swap back
    orig = {k: v.clone() for k, v in policy.state_dict().items()}
    other = build_policy(dataclasses.replace(cfg, seed=cfg.seed + 1),
                         env_params, device=dev).state_dict()
    changed, differ = 0, 0
    with CompileCounter() as c:
        engine.set_params(other)
        engine.rewarm()
        for n in served:
            rows = np.arange(n) * 7 % obs.shape[0]
            got, d, _ = _against_eager(torch, engine, obs[rows], mask[rows])
            changed += int((got != served[n]).sum())
            differ += d
        engine.set_params(orig)
        engine.rewarm()
        back = all(np.array_equal(
            engine.decide(obs[np.arange(n) * 7 % obs.shape[0]],
                          mask[np.arange(n) * 7 % obs.shape[0]])[0],
            served[n]) for n in served)
    _line("serve_swap", captures=c.total, actions_changed=changed,
          rows_differing_below_margin=differ, restored_bit_for_bit=back,
          recompiles=engine.post_warmup_recompiles)
    if c.total or not back or engine.post_warmup_recompiles:
        raise SystemExit("weight swap: the re-warm captured, raised an "
                         "alarm, or swapping back changed an action")

    # (6) the preemptive preset's graph with the stall vector
    pcfg = CONFIGS["ppo-mlp-preempt"]
    pparams = build_env_params(pcfg)
    ppolicy = build_policy(pcfg, pparams, device=dev)
    _, ptraces = fleet_windows(pcfg, 64, device=dev)
    ppool = build_request_pool(ppolicy, pparams, ptraces, steps=4)
    pobs = np.stack([o for o, _ in ppool])
    pmask = np.stack([m for _, m in ppool])
    pengine = InferenceEngine(ppolicy, max_bucket=256, device=dev,
                              env_params=pparams, strict=True)
    pengine.warmup(pobs[0], pmask[0])
    thresh = stall_threshold(pparams)
    gate = (thresh, preempt_slice(pparams, dev))
    stall = np.random.default_rng(pcfg.seed).integers(
        0, 2 * thresh, size=pobs.shape[0]).astype(np.int32)
    pre = gate[1].cpu().numpy()
    pdiffer, gated, preempts = 0, 0, 0
    for sizes in BUCKETS.values():
        for n in sizes:
            rows = np.arange(n) * 7 % pobs.shape[0]
            got, d, _ = _against_eager(torch, pengine, pobs[rows],
                                       pmask[rows], stall[rows], gate)
            pdiffer += d
            stalled = stall[rows] >= thresh
            gated += int((stalled & pmask[rows][:, pre].any(1)).sum())
            preempts += int(pre[got].sum())
            if pre[got[stalled]].any():
                raise SystemExit("a stalled request was served a preempt")
    _line("serve_preempt_graph", config=pcfg.name,
          rows_differing_below_margin=pdiffer, gated_rows=gated,
          preempt_actions_served=preempts,
          recompiles=pengine.post_warmup_recompiles)
    del pengine, ppolicy, ptraces

    # (7) the soak through the dispatcher thread
    sreg = Registry()
    server = PolicyServer(engine, registry=sreg)
    server.start()
    try:
        with _GcPauses() as gcp:
            soak = run_soak(server, pool, duration_s=SOAK_S,
                            rate_hz=SOAK_RATE, deadline_s=SOAK_DEADLINE_S)
    finally:
        server.stop()
    snap = server.slo_snapshot()
    submitted = sreg.counter("serve_requests_total").value
    shed = sreg.counter("serve_shed_total").value
    errors = sreg.counter("serve_dispatch_errors_total").value
    _line("serve_soak", **soak, **gcp.fields(),
          registry_served=snap["requests"],
          registry_shed=shed, registry_requests=submitted,
          dispatches=snap["dispatches"],
          batch_occupancy_mean=snap["batch_occupancy_mean"],
          dispatch_errors=errors,
          recompiles=engine.post_warmup_recompiles)
    if not (soak["served"] + soak["shed"] == soak["requests"] == submitted
            and snap["requests"] == soak["served"] and shed == soak["shed"]
            and errors == 0 and engine.post_warmup_recompiles == 0):
        raise SystemExit("soak: a request was neither served nor shed, or "
                         "a dispatch failed or recompiled")
    if not soak["served_second_half"]:
        raise SystemExit("soak: nothing served in the second half (the "
                         "admission estimate locked the server out)")
    if soak["shed"] > SOAK_MAX_SHED * soak["requests"]:
        # sound soaks shed 0-2 of 16,000; a lockout, or a pause learned
        # as service time, sheds thousands
        raise SystemExit(f"soak: shed {soak['shed']} of {soak['requests']}"
                         f" (over {SOAK_MAX_SHED:.0%})")
    server.close()

    # (8) the host path: stub engine, both data planes
    hp = run_host_path(pool, max_bucket=256, rounds=HOST_ROUNDS)
    legacy, arena = hp["arms"]
    _line("serve_host_path", bucket=hp["bucket"], rounds=hp["rounds"],
          **{f"{a['data_plane']}_{k}": a[k] for a in hp["arms"]
             for k in ("decisions_per_s", "alloc_calls",
                       "steady_state_slab_allocs", "conservation_ok")},
          speedup=hp["speedup"])
    if arena["alloc_calls"] or arena["steady_state_slab_allocs"] or not (
            arena["conservation_ok"] and legacy["conservation_ok"]):
        raise SystemExit(f"host path: the arena arm allocated {arena}")

    # (9) the serve CLI's bench
    lines, _, wall = _run_main(
        "rlgpuschedule_tpu_torch.serve.__main__",
        ["--config", CONFIG, "--bench", "--bucket", "256"])
    (line,) = lines
    b = line["bench"]
    _line("serve_cli", wall_s=wall, device=line.get("device"),
          graphs=b["graphs"], request_sizes=b["request_sizes"],
          latency_p50_ms=b["latency_p50_ms"],
          latency_p99_ms=b["latency_p99_ms"],
          decisions_per_s=b["decisions_per_s"],
          post_warmup_recompiles=b["post_warmup_recompiles"])
    if b["post_warmup_recompiles"] or not b["graphs"]:
        raise SystemExit(f"serve CLI bench: {b}")


def _flags(torch, tf32: bool, deterministic: bool) -> dict:
    """Set the cuDNN/TF32 switches; returns the previous ones."""
    b = torch.backends
    old = {"matmul_tf32": b.cuda.matmul.allow_tf32,
           "cudnn_tf32": b.cudnn.allow_tf32,
           "cudnn_deterministic": b.cudnn.deterministic}
    b.cuda.matmul.allow_tf32 = False     # torch's default
    b.cudnn.allow_tf32 = tf32
    b.cudnn.deterministic = deterministic
    return old


def _restore_flags(torch, old: dict) -> None:
    b = torch.backends
    b.cuda.matmul.allow_tf32 = old["matmul_tf32"]
    b.cudnn.allow_tf32 = old["cudnn_tf32"]
    b.cudnn.deterministic = old["cudnn_deterministic"]


def _state_diff(torch, a, b) -> dict:
    """Max abs difference per payload of two experiments (0.0 = the same
    bits), and whether each generator's state is equal."""
    def mx(xs, ys):
        return max((float((x.double() - y.double()).abs().max())
                    if x.is_floating_point() else
                    float((x != y).sum()) for x, y in zip(xs, ys)),
                   default=0.0)
    sa = a.train_state.opt.state_dict()["state"]
    sb = b.train_state.opt.state_dict()["state"]
    ca, cb = a.carry, b.carry
    return {
        "params": mx(list(a.net.state_dict().values()),
                     list(b.net.state_dict().values())),
        "adam_moments": mx([sa[i][k] for i in sa for k in
                            ("exp_avg", "exp_avg_sq")],
                           [sb[i][k] for i in sb for k in
                            ("exp_avg", "exp_avg_sq")]),
        "adam_step": mx([sa[i]["step"] for i in sa],
                        [sb[i]["step"] for i in sb]),
        "carry": mx(list(ca.env_state.sim) + [ca.env_state.t, ca.obs,
                                              ca.mask],
                    list(cb.env_state.sim) + [cb.env_state.t, cb.obs,
                                              cb.mask]),
        "generators_equal": bool(
            torch.equal(ca.generator.get_state(), cb.generator.get_state())
            and torch.equal(a.generator.get_state(),
                            b.generator.get_state())),
    }


def _margin_rule(torch, what, sides, steps_cap):
    """Phase 9's rule on two replays ``{device: (EvalResult,
    ReplayRecord, per-window JCTs)}`` of the same windows: the actions
    agree except after a step where the CPU's top-two margin is below
    1e-4; a window compared to the end has the same steps, n_done and
    per-job JCTs. Returns (windows compared to the end, cut-short
    windows)."""
    (rg, recg, jg), (rc, recc, jc) = sides
    steps = torch.minimum(rg.steps.cpu(), rc.steps.cpu()).clamp(
        max=steps_cap)
    splits = _first_split(recg.actions.cpu(), recc.actions.cpu(),
                          recc.margin.cpu(), steps)
    compared, cut = [], {}
    for e, sp in enumerate(splits):
        if sp is not None:
            if sp[1] >= MARGIN:
                raise SystemExit(f"{what}, window {e}: card and CPU actions "
                                 f"differ at step {sp[0]} where the CPU's "
                                 f"margin is {sp[1]}")
            cut[str(e)] = {"step": sp[0], "cpu_margin": sp[1]}
            continue
        compared.append(e)
        for k in ("steps", "n_done"):
            if int(getattr(rg, k)[e]) != int(getattr(rc, k)[e]):
                raise SystemExit(f"{what}, window {e}: {k} differs between "
                                 f"the card and the CPU")
        if jg[e] != jc[e]:
            raise SystemExit(f"{what}, window {e}: per-job JCTs differ "
                             f"between the card and the CPU")
    if not compared:
        raise SystemExit(f"{what}: no window was compared to the end")
    return compared, cut


def checkpoint_phase(torch, dev):
    """Checkpoint and resume of config 2 at its published geometry, the
    crc fallback, and the checkpoint in other processes and on the CPU
    (phase 14)."""
    import io
    import shutil
    import tempfile

    from rlgpuschedule_tpu_torch.checkpoint import STATE_FILE, Checkpointer
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.env import stack_traces
    from rlgpuschedule_tpu_torch.eval import jct_report, replay
    from rlgpuschedule_tpu_torch.experiment import (Experiment, build_policy,
                                                    restore_policy)
    from rlgpuschedule_tpu_torch.serve.fleet import fleet_replay, fleet_windows

    cfg = dataclasses.replace(CONFIGS[CONFIG], drain_frac=CKPT_DRAIN,
                              resample_every=CKPT_RESAMPLE)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    d = os.path.join(tmp, "ck")
    # the train CLI's switches (torch's defaults) for everything the CLIs
    # compare against; phase 7 left cuDNN deterministic and TF32 off
    old = _flags(torch, tf32=True, deterministic=False)
    try:
        # (1) 4 iterations, a checkpoint every 2; a resample before
        # iteration 2 (so the first checkpoint holds the state before it)
        a = Experiment.build(cfg, device=dev)
        ck = Checkpointer(d, max_to_keep=3)
        t0 = _sync(torch)
        out = a.run(CKPT_ITERS, ckpt=ck, ckpt_every=CKPT_ITERS // 2)
        train_s = _sync(torch) - t0
        steps = ck.all_steps()
        if len(steps) != 2 or out["window_cursor"] != cfg.n_envs:
            raise SystemExit(f"checkpoint: steps {steps}, cursor "
                             f"{out['window_cursor']}")
        t0 = _sync(torch)
        a.save_checkpoint(Checkpointer(os.path.join(tmp, "timed")))
        save_ms = (_sync(torch) - t0) * 1e3
        nbytes = os.path.getsize(os.path.join(d, str(steps[0]),
                                              STATE_FILE))
        # (2) a fresh experiment restores the iteration-2 step, runs 2
        b = Experiment.build(cfg, device=dev)
        t0 = _sync(torch)
        meta = b.restore_checkpoint(ck, step=steps[0])
        restore_ms = (_sync(torch) - t0) * 1e3
        b.run(CKPT_ITERS // 2)
        diff = _state_diff(torch, a, b)
        exact = diff["generators_equal"] and not any(
            v for k, v in diff.items() if k != "generators_equal")
        band = None
        if not exact:
            # two uninterrupted runs: the card's run-to-run difference
            c = Experiment.build(cfg, device=dev)
            c.run(CKPT_ITERS)
            band = _state_diff(torch, a, c)
            if not band["params"] or diff["params"] > 10 * band["params"] \
                    or not diff["generators_equal"]:
                raise SystemExit(f"resume differs from the uninterrupted "
                                 f"run by {diff}, two uninterrupted runs "
                                 f"by {band}")
        _line("checkpoint_resume", config=cfg.name, drain_frac=CKPT_DRAIN,
              resample_every=CKPT_RESAMPLE, n_envs=cfg.n_envs,
              n_steps=cfg.ppo.n_steps, iterations=CKPT_ITERS,
              steps=steps, restored_meta={k: meta[k] for k in
                                          ("iteration", "window_cursor")},
              window_cursor=b.window_cursor, adam_step=b.step,
              bit_identical=exact, resume_diff=diff,
              uninterrupted_run_to_run_diff=band,
              backend_flags={"cudnn_tf32": True,
                             "cudnn_deterministic": False},
              train_s=train_s, checkpoint_bytes=nbytes, save_ms=save_ms,
              restore_ms=restore_ms)

        # (3) a truncated newest payload: restore falls back, says so
        path = os.path.join(d, str(steps[-1]), STATE_FILE)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            ck.restore()
        said = err.getvalue().strip()
        print(said, flush=True)
        if ck.last_restored_step != steps[0] or "falling back" not in said:
            raise SystemExit(f"the crc fallback did not fire: restored "
                             f"{ck.last_restored_step}, said {said!r}")

        # (4) the evaluate and serve CLIs (they fall back to the same
        # step) against the same replays done here
        lines, _, eval_wall = _run_main(
            "rlgpuschedule_tpu_torch.evaluate",
            ["--config", CONFIG, "--ckpt-dir", d, "--drain-frac",
             str(CKPT_DRAIN), "--no-random", "--max-steps",
             str(EVAL_STEPS)])
        (ev,) = lines
        here = Experiment.build(cfg, device=dev)
        here.restore_checkpoint(Checkpointer(d), train=False)
        want = jct_report(here, max_steps=EVAL_STEPS, include_random=False)
        lines, _, serve_wall = _run_main(
            "rlgpuschedule_tpu_torch.serve.__main__",
            ["--config", CONFIG, "--ckpt-dir", d, "--fleet",
             str(CKPT_FLEET)])
        (sv,) = lines
        _, ftraces = fleet_windows(CONFIGS[CONFIG], CKPT_FLEET, device=dev)
        fl = fleet_replay(here.net, here.env_params, ftraces, device=dev)
        same_eval = all(ev[k] == want[k] for k in ROWS[:1] + BASELINES
                        + ("policy_completion", "policy_steps"))
        same_fleet = sv["fleet"]["per_cluster"] == fl["per_cluster"]
        _line("checkpoint_cli", evaluate_ckpt_step=ev["repro"]["ckpt_step"],
              serve_ckpt_step=sv["repro"]["ckpt_step"],
              evaluate_policy=ev["policy"], in_process_policy=want["policy"],
              evaluate_policy_steps=ev["policy_steps"],
              serve_fleet_mean_jct=sv["fleet"]["mean_jct"],
              in_process_fleet_mean_jct=fl["mean_jct"],
              serve_decisions=sv["fleet"]["decisions"],
              evaluate_equal=same_eval, serve_equal=same_fleet,
              evaluate_wall_s=eval_wall, serve_wall_s=serve_wall,
              evaluate_device=ev["device"], serve_device=sv["device"])
        if not (ev["repro"]["ckpt_step"] == sv["repro"]["ckpt_step"]
                == steps[0] and same_eval and same_fleet):
            raise SystemExit("a checkpoint served or evaluated in another "
                             "process disagrees with this one")
    finally:
        _restore_flags(torch, old)

    # (5) the card-written checkpoint on the CPU: a CPU run cannot
    # continue its CUDA generators; its policy replays at f32 (TF32 off)
    # within phase 9's margin rule
    refused = None
    if torch.device(dev).type != "cpu":
        try:
            Experiment.build(cfg, device="cpu").restore_checkpoint(
                Checkpointer(d))
        except ValueError as e:
            refused = str(e)
        else:
            raise SystemExit(f"a CPU experiment continued {dev} generators")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sub = here.windows[CKPT_COMPARE_FROM:CKPT_COMPARE_FROM + EVAL_COMPARE]
    sides = []
    for side in (dev, "cpu"):
        net = build_policy(cfg, here.env_params, dtype=torch.float32,
                           device=side)
        restore_policy(Checkpointer(d), net)
        traces = stack_traces(sub, here.env_params, side)
        res, states, rec = replay(net, here.env_params, traces,
                                  EVAL_STEPS, record=True,
                                  return_states=True)
        sides.append((res, rec, [_window_jcts(torch, states, traces, e)
                                 for e in range(len(sub))]))
    compared, cut = _margin_rule(torch, "checkpoint on the CPU", sides,
                                 EVAL_STEPS)
    _line("checkpoint_on_cpu", windows=len(sub), dtype="float32",
          tf32=False, compared_to_end=len(compared), cut_short=cut,
          drained=[bool((w.submit[w.valid] == 0).all()) for w in sub],
          steps=[int(x) for x in sides[1][0].steps],
          n_done=[int(x) for x in sides[1][0].n_done],
          cpu_train_restore_refused=refused)
    shutil.rmtree(tmp)


def select_phase(torch, dev):
    """Config 1 at its preset on the drain curriculum:
    ``select_checkpoint`` over the retained steps, the chosen step's
    full-trace table, and that replay card against CPU at f32 (phase
    15)."""
    import shutil
    import tempfile

    from rlgpuschedule_tpu_torch import eval as eval_lib
    from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.experiment import (Experiment, build_policy,
                                                    load_source_trace,
                                                    restore_policy)
    from rlgpuschedule_tpu_torch.sim.core import validate_trace

    cfg = dataclasses.replace(CONFIGS[BENCH_CONFIG], drain_frac=1.0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_select_")
    d = os.path.join(tmp, "ck")
    wall = {}
    t0 = _sync(torch)
    exp = Experiment.build(cfg, device=dev)
    out = exp.run(SELECT_ITERS, log_every=SELECT_ITERS - 1,
                  ckpt=Checkpointer(d, max_to_keep=3),
                  ckpt_every=SELECT_ITERS // 3)
    wall["train"] = _sync(torch) - t0
    steps = Checkpointer(d).all_steps()
    lines, _, wall["select_checkpoint"] = _run_main(
        "rlgpuschedule_tpu_torch.select_checkpoint",
        ["--config", BENCH_CONFIG, "--ckpt-dir", d, "--val-jobs",
         str(SELECT_VAL_JOBS), "--test-seed", str(SELECT_TEST_SEED)])
    (sel,) = lines
    if len(steps) != 3 or sel["step"] not in steps or \
            sorted(s for _, s in sel["ranking"]) != steps:
        raise SystemExit(f"select_checkpoint: steps {steps}, {sel}")

    # the chosen step's full-trace table, as evaluate --full-trace runs it
    test = dataclasses.replace(cfg, seed=SELECT_TEST_SEED,
                               source_jobs=SELECT_TEST_JOBS)
    texp = Experiment.build(test, device=dev)
    texp.restore_checkpoint(Checkpointer(d), step=sel["step"], train=False)
    t0 = _sync(torch)
    rep = eval_lib.full_trace_report(texp, percentiles=PERCENTILES,
                                     drain_completions=SELECT_STITCH_DRAIN)
    wall["full_trace_report"] = _sync(torch) - t0
    print(eval_lib.format_report(rep), file=sys.stderr, flush=True)

    # card against CPU at f32: the same windows, the same JCTs, unless a
    # decision below the top-two margin parts them (then named)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    source = validate_trace(texp.env_params.sim, load_source_trace(test),
                            clamp=True)
    runs = {}
    for side in (dev, "cpu"):
        net = build_policy(cfg, texp.env_params, dtype=torch.float32,
                           device=side)
        restore_policy(Checkpointer(d), net, sel["step"])
        rec = _Recorder(net)
        t0 = _sync(torch)
        with rec.windows(eval_lib):
            r = eval_lib.full_trace_replay(
                rec, texp.env_params, source,
                drain_completions=SELECT_STITCH_DRAIN)
        wall[f"f32_replay_{torch.device(side).type}"] = _sync(torch) - t0
        runs[side] = (r, rec.trace())
    (rg, (ag, mg, wg)), (rc, (ac, mc, wc)) = runs[dev], runs["cpu"]
    rel = abs(rg["avg_jct"] - rc["avg_jct"]) / abs(rc["avg_jct"])
    n = min(len(ag), len(ac))
    diff = (ag[:n] != ac[:n]).nonzero().flatten()
    split = None
    if diff.numel():
        s = int(diff[0])
        split = {"step": s, "window": int(wc[s]), "cpu_margin": float(mc[s])}
    _line("select_checkpoint", config=cfg.name, drain_frac=1.0,
          iterations=SELECT_ITERS, steps=steps,
          last_iteration=out["history"][-1], chosen_step=sel["step"],
          val_ratio=sel["val_ratio"], val_tiresias=sel["val_tiresias"],
          ranking=sel["ranking"], val_jobs=SELECT_VAL_JOBS)
    _line("full_trace", config=cfg.name, step=sel["step"],
          test_seed=SELECT_TEST_SEED, n_jobs=rep["n_jobs"],
          stitch_drain_jobs=SELECT_STITCH_DRAIN,
          windows=rep["policy_windows"],
          rows={k: rep[k] for k in ROWS}, vs_tiresias=rep["vs_tiresias"],
          percentiles=rep["percentiles"],
          f32_card_windows=rg["windows"], f32_cpu_windows=rc["windows"],
          f32_avg_jct_card=rg["avg_jct"], f32_avg_jct_cpu=rc["avg_jct"],
          f32_avg_jct_rel_diff=rel, decisions_compared=n,
          first_divergence=split, wall_s=wall)
    if not _finite(*(rep[k] for k in ROWS), rep["vs_tiresias"]):
        raise SystemExit(f"the full-trace table is not finite: {rep}")
    if rep["policy_windows"] < 2 or rg["windows"] < 2:
        raise SystemExit(f"full trace: {rep['policy_windows']} window(s) "
                         f"stitch nothing (the carry, the cutoff and the "
                         f"drain run only between windows)")
    if split is not None:
        if split["cpu_margin"] >= MARGIN:
            raise SystemExit(f"full trace: card and CPU decide differently "
                             f"in window {split['window']} at a CPU margin "
                             f"of {split['cpu_margin']}")
        print(f"full trace: card and CPU part in window {split['window']} "
              f"(decision {split['step']}, CPU margin "
              f"{split['cpu_margin']:.3g} < {MARGIN})", flush=True)
    elif rg["windows"] != rc["windows"] or rel > 1e-6:
        raise SystemExit(f"full trace: {rg['windows']} windows and avg JCT "
                         f"{rg['avg_jct']} on the card, {rc['windows']} and "
                         f"{rc['avg_jct']} on the CPU")
    shutil.rmtree(tmp)


class _Recorder:
    """Wraps a policy for :func:`..eval.full_trace_replay`: keeps each
    decision's greedy action, top-two logit margin and stitched-window
    index (one device tensor per decision, read after the replay)."""

    def __init__(self, net):
        self.net, self.window = net, 0
        self.acts, self.margins, self.wins = [], [], []

    def parameters(self):
        return self.net.parameters()

    def __call__(self, obs, mask):
        logits, value = self.net(obs, mask)
        top2 = logits.topk(2, dim=-1).values
        self.acts.append(logits.argmax(-1))
        self.margins.append(top2[:, 0] - top2[:, 1])
        self.wins.append(self.window)
        return logits, value

    @contextlib.contextmanager
    def windows(self, eval_lib):
        """Count the stitched windows while the replay runs."""
        inner = eval_lib._stitch_window

        def counted(*a, **kw):
            self.window += 1
            return inner(*a, **kw)

        eval_lib._stitch_window = counted
        try:
            yield
        finally:
            eval_lib._stitch_window = inner

    def trace(self):
        import torch
        return (torch.cat(self.acts).cpu(), torch.cat(self.margins).cpu(),
                torch.tensor(self.wins))


def _tensors(tree):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "dtype"):
        yield tree


def _run_diff(torch, a, b) -> dict:
    """Max abs difference per payload of two experiments of any
    algorithm (0.0 = the same bits; integer payloads count differing
    elements), and whether both generators' states are equal."""
    def mx(x, y):
        xs, ys = list(_tensors(x)), list(_tensors(y))
        if len(xs) != len(ys):
            return math.inf
        return max((float((u.double() - v.double()).abs().max())
                    if u.is_floating_point() else float((u != v).sum())
                    for u, v in zip(xs, ys)), default=0.0)
    ca, cb = a.carry, b.carry
    return {
        "params": mx(a.net.state_dict(), b.net.state_dict()),
        "optimizer": mx(a.train_state.opt.state_dict()["state"],
                        b.train_state.opt.state_dict()["state"]),
        "reward_stats": mx(tuple(a.train_state.reward_stats or ()),
                           tuple(b.train_state.reward_stats or ())),
        "carry": mx(tuple(ca.env_state.sim) + (ca.env_state.t, ca.obs,
                                               ca.mask),
                    tuple(cb.env_state.sim) + (cb.env_state.t, cb.obs,
                                               cb.mask)),
        "generators_equal": bool(
            torch.equal(ca.generator.get_state(), cb.generator.get_state())
            and torch.equal(a.generator.get_state(),
                            b.generator.get_state())),
    }


def _same_run(diff: dict) -> bool:
    return diff["generators_equal"] and not any(
        v for k, v in diff.items() if k != "generators_equal")


def fair_phase(torch, dev):
    """Config 3 at its published width: A2C with the fairness reward,
    card against CPU, the fairness table and the evaluate CLI (phase
    16)."""
    import shutil
    import tempfile

    from rlgpuschedule_tpu_torch.algos import a2c
    from rlgpuschedule_tpu_torch.algos import action_dist
    from rlgpuschedule_tpu_torch.algos.rollout import init_carry, rollout
    from rlgpuschedule_tpu_torch.algos.update import tree_map
    from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.env import stack_traces
    from rlgpuschedule_tpu_torch.eval import fairness_report, format_fairness
    from rlgpuschedule_tpu_torch.evaluate import _json_safe
    from rlgpuschedule_tpu_torch.experiment import (Experiment, build_policy,
                                                    load_source_trace,
                                                    make_env_windows)
    from rlgpuschedule_tpu_torch.sim.core import validate_trace

    cfg = CONFIGS[FAIR_CONFIG]
    algo = cfg.a2c
    cuda = torch.device(dev).type == "cuda"
    exp = Experiment.build(cfg, device=dev)
    warm = exp.run(1, log_every=1)
    out = exp.run(FAIR_TIMED, log_every=FAIR_TIMED)
    # one rollout and one whole iteration under the profiler
    (_, tr, _), r_ops, r_busy, r_wall = _device_account(
        torch, lambda: rollout(exp.net, exp.env_params, exp.traces,
                               exp.carry, algo.n_steps))
    (exp.train_state, exp.carry, _), i_ops, i_busy, i_wall = \
        _device_account(torch, lambda: exp.train_step(
            exp.train_state, exp.carry, exp.traces, exp.generator))
    if cuda:
        torch.cuda.set_sync_debug_mode("error")
        try:
            exp.train_state, exp.carry, _ = exp.train_step(
                exp.train_state, exp.carry, exp.traces, exp.generator)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    opt = exp.train_state.opt
    all_f32 = all(p.dtype == p.grad.dtype == opt.state[p]["nu"].dtype
                  == torch.float32 for p in exp.net.parameters())
    rows = out["history"] + warm["history"]
    _line("fair_train", config=cfg.name, algo=cfg.algo, dtype="bfloat16",
          n_envs=cfg.n_envs, n_steps=algo.n_steps, n_tenants=cfg.n_tenants,
          window_jobs=cfg.window_jobs, optimizer=type(opt).__name__,
          params=sum(p.numel() for p in exp.net.parameters()),
          warmup_s=warm["wall_s"], iterations=FAIR_TIMED,
          wall_s=out["wall_s"], env_steps_per_s=out["env_steps_per_sec"],
          rollout_device_ops_per_step=r_ops / algo.n_steps,
          rollout_busy_ms_per_step=r_busy / algo.n_steps * 1e3,
          rollout_device_idle_share=1.0 - r_busy / r_wall,
          iteration_device_ops=i_ops, iteration_busy_ms=i_busy * 1e3,
          iteration_wall_ms=i_wall * 1e3,
          device_idle_share=1.0 - i_busy / i_wall,
          iteration_without_host_sync=cuda,
          params_grads_rmsprop_f32=all_f32, metrics=rows)
    if not all_f32:
        raise SystemExit("config 3: parameters, grads or RMSprop state "
                         "not f32")
    for m in rows:
        if not _finite(m["total_loss"], m["entropy"], m["v_loss"]):
            raise SystemExit(f"config 3: non-finite metrics {m}")

    # card against CPU at f32 (TF32 off): a rollout replayed with the
    # card's actions, then one A2C learn step on its batch
    torch.backends.cuda.matmul.allow_tf32 = False
    side = {}
    for d in (dev, "cpu"):
        side[d] = (build_policy(cfg, exp.env_params, dtype=torch.float32,
                                device=d),
                   stack_traces(exp.windows, exp.env_params, d))
    net, traces = side[dev]
    carry = init_carry(exp.env_params, traces,
                       torch.Generator(dev).manual_seed(cfg.seed))
    _, tr, last = rollout(net, exp.env_params, traces, carry,
                          FAIR_REPLAY_STEPS)
    tr, last = tree_map(lambda x: x.cpu(), tr), last.cpu()
    actions = iter(tr.action)

    def replay(gen, logits):
        a = next(actions)
        return a, action_dist.log_prob(logits, a)

    net_c, traces_c = side["cpu"]
    _, tr_c, last_c = rollout(
        net_c, exp.env_params, traces_c,
        init_carry(exp.env_params, traces_c, torch.Generator()),
        FAIR_REPLAY_STEPS, sample_fn=replay)
    differ = {f: int((getattr(tr, f) != getattr(tr_c, f)).sum())
              for f in ("obs", "mask", "reward", "done", "env_steps_dt")}
    n_charged = int((tr.reward < 0).sum())
    batch = tree_map(lambda x: x[:algo.n_steps], tr)
    learn = a2c.make_learn_step(algo)
    res = {}
    for d in (dev, "cpu"):
        state, m = learn(a2c.make_train_state(side[d][0], algo),
                         tree_map(lambda x: x.to(d), batch),
                         tr.value[algo.n_steps].to(d))
        res[d] = ({n: p.detach().cpu()
                   for n, p in state.net.named_parameters()},
                  {k: float(v) for k, v in m._asdict().items()})
    (pg, mg), (pc, mc) = res[dev], res["cpu"]
    err = max(float((pg[n] - pc[n]).abs().max()) for n in pc)
    bad = {k: (mg[k], mc[k]) for k in mc if not abs(mg[k] - mc[k])
           <= METRIC_ATOL + METRIC_RTOL * abs(mc[k])}
    _line("fair_card_vs_cpu", config=cfg.name, dtype="float32", tf32=False,
          clusters=cfg.n_envs, replay_steps=FAIR_REPLAY_STEPS,
          replay_elements_differing=differ, fair_reward_charged=n_charged,
          learn_batch=algo.n_steps * cfg.n_envs,
          learn_param_max_abs_diff=err, metrics_card=mg, metrics_cpu=mc)
    if any(differ.values()) or not n_charged:
        raise SystemExit(f"config 3: card and CPU rollouts differ: {differ} "
                         f"({n_charged} rewards charged)")
    if not err <= PARAM_ATOL or bad:
        raise SystemExit(f"config 3: learn step card vs CPU: parameters "
                         f"{err} (atol {PARAM_ATOL}), metrics {bad}")
    del side

    # the fairness table of the trained policy on held-out windows, and
    # the evaluate CLI restoring it from a checkpoint
    held = dataclasses.replace(cfg, seed=cfg.seed + 1000,
                               n_envs=FAIR_WINDOWS, source_jobs=None)
    windows = make_env_windows(held, validate_trace(
        exp.env_params.sim, load_source_trace(held), clamp=True))
    t0 = _sync(torch)
    report = fairness_report(exp, windows=windows)
    wall = _sync(torch) - t0
    print(format_fairness(report), file=sys.stderr, flush=True)
    _line("fair_table", config=cfg.name, windows=len(windows),
          seed=held.seed,
          weights=f"after {FAIR_TIMED + 3} A2C iterations (bf16)",
          rows=report, wall_s=wall)
    for name, row in report.items():
        if not (_finite(row["avg_jct"], row["jain"], row["completion"])
                and 0 < row["jain"] <= 1.0):
            raise SystemExit(f"config 3 fairness table, {name}: {row}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fair_")
    try:
        with Checkpointer(os.path.join(tmp, "ck")) as ck:
            exp.save_checkpoint(ck)
        lines, _, wall = _run_main(
            "rlgpuschedule_tpu_torch.evaluate",
            ["--config", cfg.name, "--fairness", "--ckpt-dir",
             os.path.join(tmp, "ck"), "--seed", str(held.seed), "--n-envs",
             str(FAIR_WINDOWS)])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (line,) = lines
    # the CLI writes NaN as null
    want = json.loads(json.dumps(_json_safe(report)))
    same = all(line[k] == want[k] for k in report)
    _line("fair_evaluate_cli", wall_s=wall, device=line["device"],
          equal_to_in_process=same,
          rows={k: line[k] for k in report})
    if not (same and line["device"].startswith("cuda")):
        raise SystemExit(f"evaluate --fairness differs from the in-process "
                         f"report: {line}")
    del exp


def options_phase(torch, dev):
    """Config 1 with the advantage and precision options, a reward-norm
    resume and the on-policy V-trace ratios on the card (phase 17)."""
    import shutil
    import tempfile

    from rlgpuschedule_tpu_torch.algos.action_dist import log_prob
    from rlgpuschedule_tpu_torch.algos.ppo import compute_advantages
    from rlgpuschedule_tpu_torch.algos.rollout import init_carry, rollout
    from rlgpuschedule_tpu_torch.algos.vtrace import importance_ratios
    from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.experiment import Experiment, build_policy

    base = CONFIGS[BENCH_CONFIG]
    old = _flags(torch, tf32=True, deterministic=False)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_opts_")
    try:
        for opt in ("reward_norm", "bf16_update", "bf16_advantages"):
            cfg = dataclasses.replace(base, ppo=dataclasses.replace(
                base.ppo, **{opt: True}))
            exp = Experiment.build(cfg, device=dev)
            out = exp.run(1, log_every=1)
            m = out["history"][-1]
            st = exp.train_state
            f32 = all(p.dtype == p.grad.dtype == st.opt.state[p][k].dtype
                      == torch.float32 for p in exp.net.parameters()
                      for k in ("exp_avg", "exp_avg_sq"))
            _, tr, last = rollout(exp.net, exp.env_params, exp.traces,
                                  exp.carry, cfg.ppo.n_steps)
            st2, adv, ret, _ = compute_advantages(cfg.ppo, st, tr, last)
            want = torch.bfloat16 if opt == "bf16_advantages" \
                else torch.float32
            stats = st2.reward_stats
            _line("option", option=opt, config=cfg.name,
                  env_steps_per_s=out["env_steps_per_sec"], metrics=m,
                  params_grads_adam_f32=f32, advantages=str(adv.dtype),
                  returns=str(ret.dtype),
                  reward_stats=None if stats is None else
                  [float(x) for x in stats])
            if not (f32 and adv.dtype == ret.dtype == want
                    and _finite(*m.values())):
                raise SystemExit(f"option {opt}: f32 {f32}, advantages "
                                 f"{adv.dtype}, metrics {m}")
            if opt == "reward_norm" and not (
                    float(stats.count) == 2 * exp.steps_per_iteration
                    and _finite(*stats)):
                raise SystemExit(f"reward_norm: moments {stats}")
            del exp

        # a reward-norm resume: 2 iterations, a save, 2 more, against a
        # fresh experiment restored from the save
        cfg = dataclasses.replace(base, ppo=dataclasses.replace(
            base.ppo, reward_norm=True))
        a = Experiment.build(cfg, device=dev)
        a.run(2)
        with Checkpointer(os.path.join(tmp, "ck")) as ck:
            a.save_checkpoint(ck)
            a.run(2)
            b = Experiment.build(cfg, device=dev)
            b.restore_checkpoint(ck)
        b.run(2)
        diff = _run_diff(torch, a, b)
        _line("option_resume", config=cfg.name, option="reward_norm",
              iterations="2 + restore + 2", diff=diff,
              reward_stats=[float(x) for x in a.train_state.reward_stats])
        if not _same_run(diff):
            raise SystemExit(f"reward-norm resume differs: {diff}")
        del a, b

        # V-trace on on-policy batches: the ratios of the batched
        # recompute against the rollout's per-step log-probs
        vt = {}
        for dtype in (torch.float32, torch.bfloat16):
            exp = Experiment.build(base, device=dev)
            net = build_policy(base, exp.env_params, dtype=dtype, device=dev)
            state = exp.train_state._replace(net=net)
            _, tr, last = rollout(net, exp.env_params, exp.traces,
                                  init_carry(exp.env_params, exp.traces,
                                             torch.Generator(dev)
                                             .manual_seed(base.seed)),
                                  base.ppo.n_steps)
            T, E = tr.reward.shape
            with torch.no_grad():
                logits, _ = net(tr.obs.reshape(T * E, -1),
                                tr.mask.reshape(T * E, -1))
            rho = importance_ratios(tr.log_prob, log_prob(
                logits, tr.action.reshape(-1)).reshape(T, E))
            vcfg = dataclasses.replace(base.ppo, correction="vtrace")
            _, adv_g, ret_g, _ = compute_advantages(base.ppo, state, tr,
                                                    last)
            _, adv_v, ret_v, (rmean, rmax) = compute_advantages(
                vcfg, state, tr, last)
            name = str(dtype).split(".")[-1]
            dev_max = float((rho - 1.0).abs().max())
            vt[name] = {
                "max_abs_rho_minus_1": dev_max,
                "ratios_not_1": int((rho != 1.0).sum()),
                "ratios": rho.numel(), "rho_mean": float(rmean),
                "rho_max": float(rmax),
                "adv_max_abs_diff_vs_gae": float(
                    (adv_v.double() - adv_g.double()).abs().max()),
                "targets_bitwise_gae": bool(torch.equal(adv_v, adv_g)
                                            and torch.equal(ret_v, ret_g)),
                "band": RHO_BAND[name]}
            del exp
        _line("vtrace_on_policy", config=base.name, n_envs=base.n_envs,
              n_steps=base.ppo.n_steps, **vt)
        for name, v in vt.items():
            if not v["max_abs_rho_minus_1"] <= v["band"]:
                raise SystemExit(f"V-trace on-policy ratios ({name}) leave "
                                 f"their band: {v}")
    finally:
        _restore_flags(torch, old)
        shutil.rmtree(tmp, ignore_errors=True)


def fused_phase(torch, dev):
    """``run_fused`` against ``run`` on config 1 at the bench geometry,
    and the bench CLI (phase 18)."""
    from rlgpuschedule_tpu_torch.experiment import Experiment

    cfg = _bench_config()
    old = _flags(torch, tf32=True, deterministic=False)
    try:
        a = Experiment.build(cfg, device=dev)
        t0 = _sync(torch)
        m = a.run_fused(FUSED_ITERS)
        fused_s = _sync(torch) - t0
        b = Experiment.build(cfg, device=dev)
        t0 = _sync(torch)
        b.run(FUSED_ITERS)
        run_s = _sync(torch) - t0
        diff = _run_diff(torch, a, b)
        band = None
        if not _same_run(diff):
            # the card's run-to-run difference, from a second plain run
            c = Experiment.build(cfg, device=dev)
            c.run(FUSED_ITERS)
            band = _run_diff(torch, b, c)
        _line("run_fused", config=cfg.name, n_envs=cfg.n_envs,
              n_steps=cfg.ppo.n_steps, iterations=FUSED_ITERS,
              fused_s=fused_s, run_s=run_s, diff=diff,
              bit_identical=_same_run(diff), run_to_run=band,
              last_metrics={k: float(v) for k, v in m._asdict().items()})
        if band is not None and not all(
                diff[k] <= 10 * max(band[k], 1e-30) for k in diff
                if k != "generators_equal"):
            raise SystemExit(f"run_fused differs from run: {diff} "
                             f"(run to run: {band})")
        del a, b
    finally:
        _restore_flags(torch, old)
    # the bench in a process of its own, as its users run it: in this
    # process, after the earlier phases, the same fused loop runs slower
    lines, _, wall = _reap_all(
        {"bench": _spawn("rlgpuschedule_tpu_torch.bench", [])},
        timeout=900)["bench"]
    (line,) = lines
    print(json.dumps(line), flush=True)
    _line("bench_cli", wall_s=wall, value=line["value"],
          spread=line["spread"], repeats=line["repeats"])
    if not (line["metric"] == "ppo_env_steps_per_sec_per_chip[cuda]"
            and line["vs_baseline"] is None and _finite(line["value"])
            and line["power_limit"]):
        raise SystemExit(f"bench: {line}")


def _pop_snapshot(torch, pop) -> dict:
    """Clones of everything a population run carries: every member's
    parameters, Adam state, carry and generators, the hyperparameters
    and the PBT decisions so far."""
    clone = lambda tree: [t.detach().clone() for t in _tensors(tree)]
    return {
        "params": [clone(m.net.state_dict()) for m in pop.members],
        "optimizer": [clone(m.opt.state_dict()["state"])
                      for m in pop.members],
        "carry": [clone((tuple(c.env_state.pods), c.env_state.assignment,
                         c.env_state.t, c.obs, c.mask))
                  for c in pop.carries],
        "generators": [(c.generator.get_state().clone(),
                        g.get_state().clone())
                       for c, g in zip(pop.carries, pop.generators)],
        "hparams": [x.copy() for x in pop.hparams],
        "decisions": [(d.src.tolist(), d.exploited.tolist(),
                       [x.tolist() for x in d.hparams])
                      for d in pop.controller.history]}


def _pop_diff(torch, a: dict, b: dict) -> dict:
    """Max abs difference per payload of two :func:`_pop_snapshot`s (0.0
    = the same bits; integer payloads count differing elements)."""
    def mx(xs, ys):
        return max((float((u.double() - v.double()).abs().max())
                    if u.is_floating_point() else float((u != v).sum())
                    for x, y in zip(xs, ys) for u, v in zip(x, y)),
                   default=0.0)
    return {
        "params": mx(a["params"], b["params"]),
        "optimizer": mx(a["optimizer"], b["optimizer"]),
        "carry": mx(a["carry"], b["carry"]),
        "generators_equal": all(
            torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
            for x, y in zip(a["generators"], b["generators"])),
        "hparams_equal": all((x == y).all() for x, y in
                             zip(a["hparams"], b["hparams"])),
        "decisions_equal": a["decisions"] == b["decisions"]}


def hier_pbt_phase(torch, dev):
    """Config 5, ``hier-pbt-member``, at its published width: the
    hierarchical env and policy card against CPU, a single hierarchical
    run, the PBT population with its checkpoint and resume, and the
    fittest member's JCT table with ``evaluate --pbt`` (phase 19)."""
    import shutil
    import tempfile

    import numpy as np

    from rlgpuschedule_tpu_torch.algos import action_dist
    from rlgpuschedule_tpu_torch.algos.ppo import PPOMetrics
    from rlgpuschedule_tpu_torch.algos.rollout import init_carry, rollout
    from rlgpuschedule_tpu_torch.algos.update import tree_map
    from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.env import stack_traces
    from rlgpuschedule_tpu_torch.eval import format_report, jct_report
    from rlgpuschedule_tpu_torch.experiment import (Experiment,
                                                    PopulationExperiment,
                                                    build_policy,
                                                    load_source_trace,
                                                    make_env_windows,
                                                    trace_sim)
    from rlgpuschedule_tpu_torch.parallel import (PBTConfig, gather_members,
                                                  init_member,
                                                  make_member_learn_step,
                                                  member_hparams,
                                                  sample_hparams)
    from rlgpuschedule_tpu_torch.sim.core import validate_trace

    t_phase = time.perf_counter()
    cfg = CONFIGS[HIER_CONFIG]
    ppo = cfg.ppo
    cuda = torch.device(dev).type == "cuda"
    old = _flags(torch, tf32=False, deterministic=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hier_")
    try:
        # 1. card against CPU at f32 on integer traces: a rollout the
        # CPU replays with the card's actions, then one member learn step
        exp = Experiment.build(cfg, device=dev)
        P = exp.env_params.n_pods
        windows = _integer_windows(exp.windows)
        side = {d: (build_policy(cfg, exp.env_params, dtype=torch.float32,
                                 device=d),
                    stack_traces(windows, exp.env_params, d))
                for d in (dev, "cpu")}
        net, traces = side[dev]
        _, tr, last = rollout(net, exp.env_params, traces,
                              init_carry(exp.env_params, traces,
                                         torch.Generator(dev).manual_seed(
                                             cfg.seed)), HIER_REPLAY_STEPS)
        tr, last = tree_map(lambda x: x.cpu(), tr), last.cpu()
        acts = iter(range(HIER_REPLAY_STEPS))

        def replay(gen, logits):
            i = next(acts)
            a = {k: v[i] for k, v in tr.action.items()}
            return a, action_dist.log_prob(logits, a)

        net_c, traces_c = side["cpu"]
        _, tr_c, _ = rollout(net_c, exp.env_params, traces_c,
                             init_carry(exp.env_params, traces_c,
                                        torch.Generator()),
                             HIER_REPLAY_STEPS, sample_fn=replay)
        differ = {f"{f}.{k}": int((getattr(tr, f)[k]
                                   != getattr(tr_c, f)[k]).sum())
                  for f in ("obs", "mask", "action") for k in ("top", "pods")}
        differ.update({f: int((getattr(tr, f) != getattr(tr_c, f)).sum())
                       for f in ("reward", "done", "env_steps_dt")})
        routed = int((tr.action["top"] < P).sum())
        lp_err = float((tr.log_prob - tr_c.log_prob).abs().max())
        B = HIER_REPLAY_STEPS * cfg.n_envs
        gen = torch.Generator().manual_seed(cfg.seed)
        perms = [torch.randperm(B, generator=gen)
                 for _ in range(ppo.n_epochs)]
        hp = sample_hparams(ppo, 1, cfg.seed)
        learn = make_member_learn_step(ppo)
        res = {}
        for d in (dev, "cpu"):
            state, m = learn(init_member(side[d][0], ppo),
                             tree_map(lambda x: x.to(d), tr), last.to(d),
                             None, member_hparams(hp, 0, d), perms=perms)
            res[d] = ({n: p.detach().cpu()
                       for n, p in state.net.named_parameters()},
                      {k: float(v) for k, v in m._asdict().items()})
        (pg, mg), (pc, mc) = res[dev], res["cpu"]
        err = max(float((pg[n] - pc[n]).abs().max()) for n in pc)
        bad = {k: (mg[k], mc[k]) for k in mc if not abs(mg[k] - mc[k])
               <= METRIC_ATOL + METRIC_RTOL * abs(mc[k])}
        _line("hier_card_vs_cpu", elapsed_s=time.perf_counter() - t_phase,
              config=cfg.name, dtype="float32",
              tf32=False, n_pods=P, clusters=cfg.n_envs,
              replay_steps=HIER_REPLAY_STEPS, routes=routed,
              rewards_nonzero=int((tr.reward != 0).sum()),
              elements_differing=differ, log_prob_max_abs_diff=lp_err,
              learn_batch=B, learn_param_max_abs_diff=err,
              metrics_card=mg, metrics_cpu=mc)
        if any(differ.values()) or not routed:
            raise SystemExit(f"config 5: card and CPU rollouts differ: "
                             f"{differ} ({routed} routes)")
        if not err <= PARAM_ATOL or bad:
            raise SystemExit(f"config 5: member learn step card vs CPU: "
                             f"parameters {err} (atol {PARAM_ATOL}), "
                             f"metrics {bad}")
        del side, net, net_c, tr, tr_c
    finally:
        _restore_flags(torch, old)

    old = _flags(torch, tf32=True, deterministic=False)
    try:
        # 2. one hierarchical Experiment at the published geometry; the
        # profile covers a short rollout (the profiler's own teardown
        # grows with the events it holds)
        warm = exp.run(1, log_every=1)
        out = exp.run(HIER_TIMED, log_every=1)
        (_, _, _), r_ops, r_busy, r_wall = _device_account(
            torch, lambda: rollout(exp.net, exp.env_params, exp.traces,
                                   exp.carry, HIER_PROFILE_STEPS))
        rows = warm["history"] + out["history"]
        _line("hier_train", elapsed_s=time.perf_counter() - t_phase,
              config=cfg.name, dtype="bfloat16", n_pods=P,
              n_nodes=cfg.n_nodes, gpus_per_node=cfg.gpus_per_node,
              n_envs=cfg.n_envs, n_steps=ppo.n_steps,
              n_epochs=ppo.n_epochs, n_minibatches=ppo.n_minibatches,
              window_jobs=cfg.window_jobs,
              params=sum(p.numel() for p in exp.net.parameters()),
              warmup_s=warm["wall_s"], iterations=HIER_TIMED,
              wall_s=out["wall_s"], env_steps_per_s=out["env_steps_per_sec"],
              profiled_steps=HIER_PROFILE_STEPS,
              rollout_device_ops_per_step=r_ops / HIER_PROFILE_STEPS,
              rollout_busy_ms_per_step=r_busy / HIER_PROFILE_STEPS * 1e3,
              rollout_wall_ms_per_step=r_wall / HIER_PROFILE_STEPS * 1e3,
              rollout_device_idle_share=1.0 - r_busy / r_wall,
              metrics=rows)
        for m in rows:
            if not _finite(m["total_loss"], m["entropy"], m["approx_kl"]):
                raise SystemExit(f"config 5: non-finite metrics {m}")
        del exp

        # 3. the PBT population; 4. its checkpoint and a bit-for-bit
        # resume (2 iterations, a save, 1 more, against a fresh build
        # restored from the save and run 1)
        pbt_cfg = PBTConfig(ready_iters=HIER_READY, seed=cfg.seed)
        build = lambda: PopulationExperiment.build(
            cfg, n_pop=HIER_POP, pbt_cfg=pbt_cfg, device=dev)
        pop = build()
        first = pop.run(HIER_RESUME[0], log_every=1)
        ck_dir = os.path.join(tmp, "pop")
        with Checkpointer(ck_dir) as ck:
            t0 = _sync(torch)
            pop.save_checkpoint(ck)
            save_s = _sync(torch) - t0
            step = ck.latest_step()
        nbytes = sum(os.path.getsize(os.path.join(r, f))
                     for r, _, fs in os.walk(os.path.join(ck_dir, str(step)))
                     for f in fs)
        second = pop.run(HIER_RESUME[1], log_every=1)
        straight = _pop_snapshot(torch, pop)
        third = pop.run(HIER_POP_ITERS - sum(HIER_RESUME), log_every=1)
        hist = first["history"] + second["history"] + third["history"]
        last = pop.controller.history[-1]
        same_as_src = all(
            all(torch.equal(a, b) for a, b in zip(
                pop.members[i].net.parameters(),
                pop.members[int(s)].net.parameters()))
            for i, s in enumerate(last.src) if s != i)
        t0 = _sync(torch)
        gather_members(pop.members, last.src)
        exploit_ms = (_sync(torch) - t0) * 1e3
        wall = first["wall_s"] + second["wall_s"] + third["wall_s"]
        fitness = third["final_fitness"]
        _line("hier_pbt", elapsed_s=time.perf_counter() - t_phase,
              config=cfg.name, n_pop=HIER_POP,
              ready_iters=HIER_READY, iterations=HIER_POP_ITERS,
              env_steps_per_iteration=pop.steps_per_iteration,
              env_steps_per_s=HIER_POP_ITERS * pop.steps_per_iteration / wall,
              wall_s=wall, pbt_events=len(pop.controller.history),
              final_fitness=fitness,
              decisions=[{"src": d.src.tolist(),
                          "exploited": d.exploited.tolist()}
                         for d in pop.controller.history],
              hparams={k: v.tolist()
                       for k, v in pop.hparams._asdict().items()},
              exploited_equal_source=same_as_src,
              exploit_gather_ms=exploit_ms,
              mean_reward=[h["mean_reward_mean"] for h in hist])
        if not (len(pop.controller.history) >= 1 and _finite(*fitness)
                and last.exploited.any() and same_as_src):
            raise SystemExit(f"config 5: PBT round(s) "
                             f"{len(pop.controller.history)}, fitness "
                             f"{fitness}, exploited members equal to "
                             f"their sources: {same_as_src}")
        with Checkpointer(ck_dir) as ck:
            resumed = build()
            t0 = _sync(torch)
            resumed.restore_checkpoint(ck, step=step)
            restore_s = _sync(torch) - t0
        resumed.run(HIER_RESUME[1])
        diff = _pop_diff(torch, straight, _pop_snapshot(torch, resumed))
        _line("hier_pbt_checkpoint", elapsed_s=time.perf_counter() - t_phase,
              step=step, bytes=nbytes,
              save_ms=save_s * 1e3, restore_ms=restore_s * 1e3,
              iterations=f"{HIER_RESUME[0]} + restore + {HIER_RESUME[1]} "
                         f"against {sum(HIER_RESUME)} straight",
              diff=diff)
        if not (diff["generators_equal"] and diff["hparams_equal"]
                and diff["decisions_equal"] and not diff["params"]
                and not diff["optimizer"] and not diff["carry"]):
            raise SystemExit(f"config 5: population resume differs: {diff}")
        del resumed

        # 5. the fittest member's table on held-out windows, and the
        # evaluate CLI restoring the same population
        with Checkpointer(os.path.join(tmp, "final")) as ck:
            pop.save_checkpoint(ck)
        held = dataclasses.replace(cfg, seed=cfg.seed + 1000,
                                   n_envs=HIER_WINDOWS, source_jobs=None)
        windows = make_env_windows(held, validate_trace(
            trace_sim(pop.env_params), load_source_trace(held), clamp=True))
        view = pop.member_eval_view()
        report = jct_report(view, windows=windows, backend="native")
        print(format_report(report), file=sys.stderr, flush=True)
        rows = {k: report[k] for k in ROWS}
        _line("hier_eval", elapsed_s=time.perf_counter() - t_phase,
              config=cfg.name, windows=len(windows),
              seed=held.seed, member=view.member,
              weights=f"fittest of {HIER_POP} after {HIER_POP_ITERS} PBT "
                      f"iterations (bf16)",
              rows=rows, policy_completion=report["policy_completion"],
              vs_tiresias=report["vs_tiresias"],
              policy_steps=report["policy_steps"], wall_s=report["wall_s"])
        if not _finite(*rows.values(), report["vs_tiresias"],
                       report["policy_completion"]):
            raise SystemExit(f"config 5: non-finite JCT table {report}")
        lines, _, wall = _run_main(
            "rlgpuschedule_tpu_torch.evaluate",
            ["--config", cfg.name, "--pbt", "--n-pop", str(HIER_POP),
             "--ckpt-dir", os.path.join(tmp, "final"), "--seed",
             str(held.seed), "--n-envs", str(HIER_WINDOWS)])
        (line,) = lines
        same = all(line[k] == report[k] for k in ROWS + (
            "policy_completion", "vs_tiresias"))
        _line("hier_evaluate_cli", elapsed_s=time.perf_counter() - t_phase,
              wall_s=wall, device=line["device"],
              member=line["repro"]["member"], equal_to_in_process=same,
              rows={k: line[k] for k in ROWS})
        if not (same and line["repro"]["member"] == view.member
                and line["device"].startswith("cuda" if cuda else "cpu")):
            raise SystemExit(f"evaluate --pbt differs from the in-process "
                             f"report: {line}")
        del pop
    finally:
        _restore_flags(torch, old)
        shutil.rmtree(tmp, ignore_errors=True)


def _top2_margin(torch, logits):
    """The gap between the two largest logits of each row, on the host
    (the near-tie rule's measure)."""
    top2 = torch.topk(logits.float(), 2, -1).values.cpu().numpy()
    return top2[..., 0] - top2[..., 1]


def _margin_ok(torch, got, want, logits, what):
    """Per head, actions that differ must sit below ``MARGIN`` of the
    reference's top-two logits (phase 3's rule). Returns the count of
    differing actions."""
    import numpy as np

    off = 0
    for k in (got if isinstance(got, dict) else {None: got}):
        g = got[k] if k is not None else got
        w = want[k] if k is not None else want
        lg = logits[k] if k is not None else logits
        margin = _top2_margin(torch, lg)[:g.shape[0]]
        diff = np.asarray(g) != np.asarray(w)
        if (diff & (margin >= MARGIN)).any():
            raise SystemExit(f"{what}: head {k} differs at a margin >= "
                             f"{MARGIN}")
        off += int(diff.sum())
    return off


def router_phase(torch, dev):
    """Phase 20: the multi-engine router on one card, and config 5
    through one engine and the server."""
    import numpy as np

    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.experiment import (build_env_params,
                                                    build_policy)
    from rlgpuschedule_tpu_torch.obs import Registry
    from rlgpuschedule_tpu_torch.serve import (
        AutoscaleAdvisor, EngineRouter, InferenceEngine, PolicyServer,
        ServeFaultInjector, build_request_pool, pad_batch,
        parse_serve_fault, run_chaos_soak, run_scaleout, run_soak)
    from rlgpuschedule_tpu_torch.serve.fleet import fleet_windows
    from rlgpuschedule_tpu_torch.traces.fit import domain_fit

    cfg = CONFIGS[CONFIG]
    env_params = build_env_params(cfg)
    policy = build_policy(cfg, env_params, device=dev)
    _, traces = fleet_windows(cfg, 64, device=dev)
    pool = build_request_pool(policy, env_params, traces, steps=4)
    del traces
    obs = np.stack([o for o, _ in pool])
    mask = np.stack([m for _, m in pool])

    # (1) scale-out: 1 against 2 engines sharing the card
    so = run_scaleout(policy, env_params, pool, max_bucket=256,
                      rounds=ROUTER_ROUNDS, request_sizes=ROUTER_SIZES,
                      engine_counts=(1, 2), device=dev)
    for arm in so["arms"]:
        _line("router_scaleout", **arm, caveat=so["caveat"])
        if (arm["served"] != arm["requests"]
                or sum(arm["per_engine_rows"]) != arm["served"]
                or any(arm["per_engine_recompiles"])
                or not all(arm["per_engine_rows"])):
            raise SystemExit(f"scale-out arm {arm['engines']}: a request "
                             f"unserved, an idle engine or a recompile")

    # (2) routed actions against one engine on the same batches
    single = InferenceEngine(policy, max_bucket=256, device=dev)
    router = EngineRouter(policy, env_params, max_bucket=256,
                          registry=Registry(), n_engines=2, device=dev)
    for e in (single, router):
        e.warmup(obs[0], mask[0])
    differ = 0
    for sizes in BUCKETS.values():
        for n in sizes:
            for shift in (0, 1):      # each batch through both engines
                rows = (np.arange(n) * 7 + shift) % obs.shape[0]
                a_r, b = router.decide(obs[rows], mask[rows])
                a_s, _ = single.decide(obs[rows], mask[rows])
                with torch.no_grad():
                    logits, _ = single.policy(
                        torch.from_numpy(pad_batch(obs[rows], b)).to(dev),
                        torch.from_numpy(pad_batch(mask[rows], b,
                                                   True)).to(dev))
                differ += _margin_ok(torch, a_r, a_s, logits,
                                     f"routed {n} requests")
    _line("router_vs_one_engine", rows_differing_below_margin=differ,
          per_engine_rows=[s.rows for s in router.stats()],
          recompiles=router.per_engine_recompiles())
    if not all(s.rows for s in router.stats()) or any(
            router.per_engine_recompiles()):
        raise SystemExit("routed decisions: an engine idle or recompiling")
    del router, single

    # (3) the routed soak with the advisor: engine 1 spun up under load
    reg = Registry()
    router = EngineRouter(policy, env_params, max_bucket=256, registry=reg,
                          n_engines=2, device=dev)
    router.set_active(1)
    router.warmup(obs[0], mask[0])              # engine 0 only
    cold = router.engines[1].warmed_buckets
    advisor = AutoscaleAdvisor(reg, n_max=2, initial=1,
                               p99_target_ms=ROUTER_P99_TARGET_MS,
                               hysteresis=2)
    server = PolicyServer(router, registry=reg)
    server.start(dispatchers=2)
    try:
        with _GcPauses() as gcp:
            soak = run_soak(server, pool, duration_s=ROUTER_SOAK_S,
                            rate_hz=ROUTER_RATE, deadline_s=SOAK_DEADLINE_S,
                            router=router, advisor=advisor)
    finally:
        server.stop()
    errors = reg.counter("serve_dispatch_errors_total").value
    submitted = reg.counter("serve_requests_total").value
    _line("router_autoscale_soak", **soak, **gcp.fields(),
          engine1_cold_at_start=cold == (),
          engine1_warmed=list(router.engines[1].warmed_buckets),
          advisor_desired=advisor.desired, dispatch_errors=errors,
          registry_requests=submitted)
    if not (soak["served"] + soak["shed"] == soak["requests"] == submitted
            and errors == 0 and soak["served_second_half"]
            and soak["autoscale_resizes"] and cold == ()
            and soak["per_engine_rows"][1] > 0
            and not any(soak["per_engine_recompiles"])):
        raise SystemExit("autoscale soak: a request lost, a dispatch "
                         "failed, no spin-up, or a recompile")
    server.close()
    del router, server

    # (4) the chaos soak: faults on engine 1, the hedge absorbs them
    reg = Registry()
    specs = [parse_serve_fault(x) for x in CHAOS_FAULTS.split(",")]
    router = EngineRouter(policy, env_params, max_bucket=256, registry=reg,
                          n_engines=2, device=dev,
                          fault_injector=ServeFaultInjector(specs))
    router.warmup(obs[0], mask[0])
    server = PolicyServer(router, registry=reg)
    server.start(dispatchers=2)
    try:
        chaos = run_chaos_soak(server, pool, fit=domain_fit(cfg),
                               duration_s=CHAOS_S, rate_hz=CHAOS_RATE,
                               deadline_s=SOAK_DEADLINE_S, router=router,
                               seed=cfg.seed)
    finally:
        server.stop()
    errors = reg.counter("serve_dispatch_errors_total").value
    _line("router_chaos_soak", faults=CHAOS_FAULTS,
          fired=[x.fired for x in specs], dispatch_errors=errors,
          **{k: v for k, v in chaos.items() if k != "slo"},
          slo_alerting={k: v["alerting"] for k, v in chaos["slo"].items()})
    if not (chaos["conservation_ok"] and chaos["failed"] == 0
            and all(x.fired for x in specs) and errors == 0
            and chaos["registry_shed_total"] == chaos["shed"]
            and not any(chaos["per_engine_recompiles"])):
        raise SystemExit("chaos soak: conservation broken, a request "
                         "failed, a fault never fired, or a recompile")
    server.close()
    del router, server, policy

    # (5) config 5 through one engine: graph, eager and CPU at f32, TF32
    # off (phase 7's switches, put back after)
    old = _flags(torch, tf32=False, deterministic=True)
    try:
        _hier_serve(torch, dev)
    finally:
        _restore_flags(torch, old)


def _fed_replay_check(torch, what, env_params, windows, schedules, policy,
                      dev):
    """The first ``CHAOS_COMPARE`` windows replayed under their schedules
    on the card with ``policy`` (actions recorded) and on the CPU with
    those actions fed back: the final states, the per-job JCTs and every
    ``EvalResult`` field but ``avg_jct`` must be the same bits;
    ``avg_jct``, an f32 sum over the window whose order differs between
    the devices, within rtol 1e-6 (phase 3's rule). Returns the steps
    compared and the completion."""
    from rlgpuschedule_tpu_torch.env import stack_traces
    from rlgpuschedule_tpu_torch.eval import replay
    from rlgpuschedule_tpu_torch.sim.faults import stack_fault_schedules

    class Feed(torch.nn.Module):
        """Plays the recorded actions, one row per decision step."""

        def __init__(self, actions, n_actions):
            super().__init__()
            self.actions, self.n, self.i = actions, n_actions, 0

        def forward(self, obs, mask):
            a = self.actions[self.i]
            self.i += 1
            hot = torch.arange(self.n) == a[:, None]
            return (torch.where(hot, 0.0, -1e9),
                    torch.zeros(a.shape[0]))

    sub = windows[:CHAOS_COMPARE]
    side = {}
    for d in (dev, "cpu"):
        traces = stack_traces(sub, env_params, d)
        faults = stack_fault_schedules(schedules[:CHAOS_COMPARE], d)
        if d == dev:
            res, st, rec = replay(policy, env_params, traces,
                                  return_states=True, record=True,
                                  faults=faults)
            feed = Feed(rec.actions.cpu(), env_params.n_actions)
        else:
            res, st = replay(feed, env_params, traces, return_states=True,
                             faults=faults)
        side[d] = (res, st, traces)
    (rg, sg, tg), (rc, sc, tc) = side[dev], side["cpu"]
    pairs = [(f"sim.{f}", getattr(sg.sim, f), getattr(sc.sim, f))
             for f in sc.sim._fields]
    pairs += [(f"result.{f}", getattr(rg, f), getattr(rc, f))
              for f in rc._fields if f != "avg_jct"]
    rel = float(((rg.avg_jct.cpu().double() - rc.avg_jct.double()).abs()
                 / rc.avg_jct.double().abs().clamp_min(1e-30)).max())
    if rel > 1e-6:
        raise SystemExit(f"{what}: avg_jct differs by {rel} (relative) "
                         f"between the card and the CPU")
    for name, x, y in pairs:
        x = x.cpu()
        if not (x.dtype == y.dtype
                and x.numpy().tobytes() == y.numpy().tobytes()):
            raise SystemExit(f"{what}: {name} differs between the card and "
                             f"the CPU")
    for e in range(len(sub)):
        if _window_jcts(torch, sg, tg, e) != _window_jcts(torch, sc, tc, e):
            raise SystemExit(f"{what}: window {e}'s JCTs differ between the "
                             f"card and the CPU")
    return (int(rc.steps.sum()), float(rc.n_done.sum() / rc.n_valid.sum()),
            rel)


def _rows_card_cpu(torch, what, table_g, table_c, policy_rows, explain):
    """Phase 21: a chaos or matrix table on the card against the same
    table on the CPU: the baseline rows equal, the policy rows within
    rtol 1e-6 with the same completion. A policy row that differs is
    replayed on both devices with its actions recorded
    (``explain(regime, row)``) and held to phase 9's margin rule: the
    actions may part only where the CPU's top-two margin is below 1e-4.
    Returns the windows so cut short, by cell."""
    cut = {}
    for regime, cells in table_c.items():
        for sched, cell in cells.items():
            got = table_g[regime][sched]
            if sched not in policy_rows:
                if got != cell:
                    raise SystemExit(f"{what} ({regime}, {sched}): {got} on "
                                     f"the card vs {cell} on the CPU")
                continue
            if (got["completion"] == cell["completion"]
                    and abs(got["avg_jct"] - cell["avg_jct"])
                    <= 1e-6 * abs(cell["avg_jct"])):
                continue
            _, c = explain(regime, sched)
            if not c:
                raise SystemExit(f"{what} ({regime}, {sched}): {got} on the "
                                 f"card vs {cell} on the CPU, and no "
                                 f"near-tie parts their actions")
            cut[f"{regime}/{sched}"] = c
    return cut


def chaos_phase(torch, dev):
    """Phase 21: cluster chaos and domain randomization on the card."""
    import shutil
    import tempfile

    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.domains import (
        domain_schedule, sample_env_domains, stack_domain_schedules,
        validate_domain_schedule)
    from rlgpuschedule_tpu_torch.env import stack_traces
    from rlgpuschedule_tpu_torch.eval import replay
    from rlgpuschedule_tpu_torch.experiment import (build_env_params,
                                                    build_policy,
                                                    make_domain_windows)
    from rlgpuschedule_tpu_torch.serve.fleet import (fleet_replay,
                                                     fleet_windows,
                                                     sample_fleet_faults)
    from rlgpuschedule_tpu_torch.sim.faults import (fault_horizon,
                                                    sample_fault_schedule)

    # (1) config 2's fleet, clean and under storm schedules
    cfg = CONFIGS[CONFIG]
    env_params = build_env_params(cfg)
    windows, traces = fleet_windows(cfg, N_CLUSTERS, device=dev)
    storm = sample_fleet_faults(cfg.n_nodes, "storm", 0, N_CLUSTERS,
                                windows, dev)
    policy = build_policy(cfg, env_params, device=dev)
    fleet_replay(policy, env_params, traces, max_steps=4, device=dev,
                 faults=storm)
    for name, f in (("clean", None), ("storm", storm)):
        fl = fleet_replay(policy, env_params, traces, device=dev, faults=f)
        prof = _replay_profile(torch, env_params, traces, policy,
                               *SHORT_PROFILE, faults=f)
        _line("chaos_fleet", config=cfg.name, regime=name,
              n_clusters=fl["n_clusters"], decisions=fl["decisions"],
              wall_s=fl["wall_s"], decisions_per_s=fl["decisions_per_s"],
              mean_jct=fl["mean_jct"], completion=fl["completion"],
              **{k: prof[k] for k in (
                  "launches_per_step", "step_ms_unprofiled",
                  "device_idle_share_unprofiled")})
        if not (fl["completion"] > 0 and _finite(fl["mean_jct"],
                                                 fl["decisions_per_s"])):
            raise SystemExit(f"fleet under {name}: nothing completed or a "
                             f"non-finite value")
    horizon_s = fault_horizon(windows)
    host = [sample_fault_schedule(cfg.n_nodes, "storm", (0, e), horizon_s)
            for e in range(CHAOS_COMPARE)]
    steps, completion, rel = _fed_replay_check(
        torch, "storm fleet", env_params, windows, host, policy, dev)
    _line("chaos_card_vs_cpu", config=cfg.name, schedule="storm",
          clusters=CHAOS_COMPARE, steps=steps, completion=completion,
          states_jcts_bit_identical=True, avg_jct_max_rel_diff=rel)

    # (2) the same policy under mixed domain draws
    dcfg = dataclasses.replace(cfg, domains="mixed")
    dparams = build_env_params(dcfg)
    draws = sample_env_domains("mixed", cfg.n_nodes, cfg.gpus_per_node,
                               cfg.seed, N_CLUSTERS)
    t0 = time.perf_counter()
    dwindows = make_domain_windows(dcfg, draws)
    dhost = [validate_domain_schedule(cfg.n_nodes, cfg.gpus_per_node,
                                      domain_schedule(d)) for d in draws]
    dtraces = stack_traces(dwindows, dparams, dev)
    mixed = stack_domain_schedules(dhost, dev)
    gen_s = time.perf_counter() - t0
    t0 = _sync(torch)
    res = replay(policy, dparams, dtraces, faults=mixed)
    wall = _sync(torch) - t0
    prof = _replay_profile(torch, dparams, dtraces, policy, *SHORT_PROFILE,
                           faults=mixed)
    done, valid = int(res.n_done.sum()), int(res.n_valid.sum())
    _line("chaos_domains", config=cfg.name, regime="mixed",
          n_clusters=N_CLUSTERS, windows_and_schedules_s=gen_s,
          replay_wall_s=wall, decisions=int(res.steps.sum()),
          decisions_per_s=int(res.steps.sum()) / wall,
          completion=done / valid,
          mean_total_gpus=float(mixed.capacity.sum(1).float().mean()),
          **{k: prof[k] for k in (
              "launches_per_step", "step_ms_unprofiled",
              "device_idle_share_unprofiled")})
    if not done:
        raise SystemExit("the mixed-domain replay completed no job")
    steps, completion, rel = _fed_replay_check(
        torch, "mixed domains", dparams, dwindows, dhost, policy, dev)
    _line("chaos_card_vs_cpu", config=cfg.name, schedule="mixed",
          clusters=CHAOS_COMPARE, steps=steps, completion=completion,
          states_jcts_bit_identical=True, avg_jct_max_rel_diff=rel)
    del policy, traces, dtraces, storm, mixed, windows, dwindows

    # (3) config 1: the train CLI clean, under storm faults and across
    # mixed domains, then the chaos and generalization tables
    name = "ppo-mlp-synth64"
    root = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    try:
        _chaos_tables(torch, dev, name, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _chaos_tables(torch, dev, name, root):
    """Phase 21 (3): config 1 trained clean, under storm faults and across
    mixed domains into ``root``, then the chaos and generalization
    tables on the card and on the CPU."""
    from rlgpuschedule_tpu_torch import evaluate as evaluate_cli
    from rlgpuschedule_tpu_torch import train as train_cli
    from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.domains import (
        domain_schedule, sample_env_domains, validate_domain_schedule)
    from rlgpuschedule_tpu_torch.env import stack_traces
    from rlgpuschedule_tpu_torch.eval import (chaos_report, matrix_report,
                                              replay)
    from rlgpuschedule_tpu_torch.experiment import (Experiment,
                                                    build_policy,
                                                    make_domain_windows)
    from rlgpuschedule_tpu_torch.sim.faults import (fault_horizon,
                                                    sample_fault_schedule,
                                                    stack_fault_schedules)

    rates = {}
    for label, flags in (("clean", []), ("storm", ["--faults", "storm"]),
                         ("mixed", ["--domains", "mixed"])):
        summary = train_cli.main([
            "--config", name, "--iterations", str(CHAOS_TRAIN_ITERS),
            "--log-every", "100", "--ckpt-dir",
            os.path.join(root, label), *flags])
        rates[label] = summary["env_steps_per_sec"]
    _line("chaos_train", config=name, iterations=CHAOS_TRAIN_ITERS,
          env_steps_per_sec=rates)
    ccfg = dataclasses.replace(CONFIGS[name], faults="storm")
    chaos = evaluate_cli.main(["--config", name, "--faults", "storm",
                               "--ckpt-dir", os.path.join(root, "storm"),
                               "--chaos"])
    mcfg = dataclasses.replace(CONFIGS[name], domains="mixed")
    matrix = evaluate_cli.main([
        "--config", name, "--domains", "mixed", "--ckpt-dir",
        os.path.join(root, "mixed"), "--matrix", "--matrix-ckpt",
        f"clean={os.path.join(root, 'clean')}"])
    for what, rep in (("chaos", chaos), ("matrix", matrix)):
        if rep["jobs_lost"]:
            raise SystemExit(f"{what}: {rep['jobs_lost']} jobs lost")
    # the same tables, f32 weights from the checkpoints, card and CPU
    old = _flags(torch, tf32=False, deterministic=True)
    try:
        tables = {}
        for d in (dev, "cpu"):
            exps = {}
            for label, c in (("storm", ccfg), ("mixed", mcfg),
                             ("clean", CONFIGS[name])):
                e = Experiment.build(c, device=d)
                e.train_state = e.train_state._replace(
                    net=build_policy(c, e.env_params, dtype=torch.float32,
                                     device=d))
                with Checkpointer(os.path.join(root, label)) as ck:
                    e.restore_checkpoint(ck, train=False)
                exps[label] = e
            t0 = _sync(torch)
            ch = chaos_report(exps["storm"])
            mx = matrix_report(exps["mixed"], policies={
                "mixed": (exps["mixed"].net, exps["mixed"].env_params),
                "clean": (exps["clean"].net, exps["clean"].env_params)})
            tables[d] = (ch, mx, _sync(torch) - t0, exps)

        def explain(kind):
            """Replays of one cell on both devices, phase 9's rule."""
            def run(regime, row):
                if kind == "chaos":
                    wins = tables["cpu"][3]["storm"].windows
                    h = fault_horizon(wins)
                    sch = [sample_fault_schedule(ccfg.n_nodes, regime,
                                                 (0, e), h)
                           for e in range(len(wins))]
                    label = "storm"
                else:
                    ds = sample_env_domains(regime, mcfg.n_nodes,
                                            mcfg.gpus_per_node, 0,
                                            mcfg.n_envs)
                    wins = make_domain_windows(
                        dataclasses.replace(mcfg, seed=0), ds)
                    sch = [validate_domain_schedule(
                        mcfg.n_nodes, mcfg.gpus_per_node,
                        domain_schedule(x)) for x in ds]
                    label = row
                sides = []
                for d in (dev, "cpu"):
                    e = tables[d][3][label]
                    tr = stack_traces(wins, e.env_params, d)
                    f = stack_fault_schedules(sch, d)
                    res, st, rec = replay(e.net, e.env_params, tr,
                                          return_states=True, record=True,
                                          faults=f)
                    sides.append((res, rec, [_window_jcts(torch, st, tr, i)
                                             for i in range(len(wins))]))
                return _margin_rule(torch, f"{kind} {regime}/{row}",
                                    sides, 1 << 30)
            return run

        (chg, mxg, wg, _), (chc, mxc, wc, _) = tables[dev], tables["cpu"]
        cut = _rows_card_cpu(torch, "chaos", chg["regimes"], chc["regimes"],
                             ("policy",), explain("chaos"))
        cut.update(_rows_card_cpu(torch, "matrix", mxg["cells"],
                                  mxc["cells"], ("mixed", "clean"),
                                  explain("matrix")))
    finally:
        _restore_flags(torch, old)
    _line("chaos_tables", config=name, chaos_jobs_lost=chg["jobs_lost"],
          matrix_jobs_lost=mxg["jobs_lost"],
          chaos_policy_jct={r: c["policy"]["avg_jct"]
                            for r, c in chg["regimes"].items()},
          chaos_degradation={r: {s: x["degradation"] for s, x in c.items()}
                             for r, c in chg["regimes"].items()},
          matrix_degradation={r: {s: x["degradation"] for s, x in c.items()}
                              for r, c in mxg["cells"].items()},
          card_s=wg, cpu_s=wc, rows_cut_short_by_near_ties=cut)


def _hier_serve(torch, dev):
    """Phase 20 (5): config 5 through one engine and the serve CLI."""
    import copy

    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.decision import policy_decision
    from rlgpuschedule_tpu_torch.experiment import (build_env_params,
                                                    build_policy)
    from rlgpuschedule_tpu_torch.serve import (InferenceEngine,
                                               build_request_pool,
                                               stack_requests)
    from rlgpuschedule_tpu_torch.serve.fleet import fleet_windows

    hcfg = CONFIGS[HIER_CONFIG]
    hparams = build_env_params(hcfg)
    _, htraces = fleet_windows(hcfg, hcfg.n_envs, device=dev)
    # the first seed from the config's whose greedy top head routes some
    # row of its pool and plays more than one action there: a pool where
    # every row plays no-op would hold the top head to one constant
    # action, and the margin rule would pass a wrong router head (the
    # orthogonal init goes through LAPACK, so which seed routes differs
    # between machines)
    for seed in range(hcfg.seed, hcfg.seed + HIER_SERVE_SEEDS):
        hpolicy = build_policy(hcfg, hparams, dtype=torch.float32,
                               device=dev, seed=seed)
        with torch.no_grad():
            # heads scaled up from their 0.01-gain init, as the parity
            # tests do
            hpolicy.top_policy.weight.mul_(300)
            hpolicy.pod_policy.weight.mul_(300)
        hpool = build_request_pool(hpolicy, hparams, htraces, steps=7)
        with torch.no_grad():
            top = policy_decision(
                hpolicy,
                {k: torch.from_numpy(v).to(dev) for k, v in
                 stack_requests([o for o, _ in hpool]).items()},
                {k: torch.from_numpy(v).to(dev) for k, v in
                 stack_requests([m for _, m in hpool]).items()},
            )["top"].cpu().numpy()
        if (top < hparams.n_pods).any() and len(set(top.tolist())) > 1:
            break
    else:
        raise SystemExit(f"config 5: no seed of {HIER_SERVE_SEEDS} routes "
                         f"a row of its pool")
    del htraces
    engines = {
        "graph": InferenceEngine(hpolicy, max_bucket=64, device=dev,
                                 env_params=hparams),
        "eager": InferenceEngine(hpolicy, max_bucket=64, device=dev,
                                 env_params=hparams, eager=True),
        "cpu": InferenceEngine(copy.deepcopy(hpolicy).cpu(), max_bucket=64,
                               device="cpu", env_params=hparams)}
    for e in engines.values():
        e.warmup(*hpool[0])
    differ = {"eager": 0, "cpu": 0}
    routes = routable = 0
    for n in HIER_SERVE_SIZES:
        rows = [hpool[(i * 5) % len(hpool)] for i in range(n)]
        ho = stack_requests([o for o, _ in rows])
        hm = stack_requests([m for _, m in rows])
        got = {k: e.decide(ho, hm)[0] for k, e in engines.items()}
        with torch.no_grad():
            logits, _ = engines["cpu"].policy(
                {k: torch.from_numpy(v) for k, v in ho.items()},
                {k: torch.from_numpy(v) for k, v in hm.items()})
        for other in differ:
            differ[other] += _margin_ok(torch, got["graph"], got[other],
                                        logits, f"config 5 graph vs "
                                        f"{other}, {n} requests")
        routes += int((got["graph"]["top"] < hparams.n_pods).sum())
        routable += int(hm["top"][:, :-1].any(-1).sum())
    _line("hier_serve_engine", seed=seed, pool_rows=len(hpool),
          sizes=list(HIER_SERVE_SIZES), graphs=engines["graph"].graphs,
          differing_below_margin=differ, routable_rows=routable,
          routes_served=routes,
          recompiles=engines["graph"].post_warmup_recompiles)
    if not engines["graph"].graphs or engines["graph"].post_warmup_recompiles:
        raise SystemExit("config 5: no graph, or a recompile")
    if not routes:
        # every row no-op: the top head's comparison would hold one
        # constant action
        raise SystemExit(f"config 5: no row routed ({routable} could)")
    lines, _, wall = _run_main(
        "rlgpuschedule_tpu_torch.serve.__main__",
        ["--config", HIER_CONFIG, "--bench", "--bucket", "64", "--soak",
         "2", "--rate", "1000", "--deadline-ms", "50"])
    (line,) = lines
    b, sk = line["bench"], line["soak"]
    _line("hier_serve_cli", wall_s=wall, graphs=b["graphs"],
          bench_p50_ms=b["latency_p50_ms"], bench_p99_ms=b["latency_p99_ms"],
          bench_decisions_per_s=b["decisions_per_s"],
          bench_recompiles=b["post_warmup_recompiles"],
          soak_requests=sk["requests"], soak_served=sk["served"],
          soak_shed=sk["shed"], soak_p99_ms=[sk["p99_first_half_ms"],
                                             sk["p99_second_half_ms"]],
          soak_recompiles=sk["post_warmup_recompiles"])
    if (b["post_warmup_recompiles"] or not b["graphs"]
            or sk["post_warmup_recompiles"] or sk["dispatch_errors"]
            or sk["served"] + sk["shed"] != sk["requests"]
            or not sk["served_second_half"]):
        raise SystemExit(f"config 5 serve CLI: {b} {sk}")


def _http_decide(obs, mask, headers=()) -> bytes:
    """One keep-alive ``POST /v1/decide`` as raw bytes."""
    body = obs.tobytes() + mask.tobytes()
    head = ["POST /v1/decide HTTP/1.1", "Host: smoke",
            f"Content-Length: {len(body)}", *headers]
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _http_read(f) -> "tuple[int, dict, dict | None]":
    """One Content-Length-framed HTTP response off a socket file."""
    status_line = f.readline()
    if not status_line:
        raise SystemExit("front door: connection closed before a response")
    headers = {}
    while True:
        line = f.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    body = f.read(int(headers.get("content-length", "0")))
    return (int(status_line.split()[1]), headers,
            json.loads(body) if body else None)


def _wire_client(k, port, framed, obs, mask, rows, extras, barrier,
                 results):
    """One client process of phase 22: a keep-alive connection (HTTP or
    framed) that sends row ``rows[j]`` of ``obs``/``mask`` with
    ``extras[j]`` (headers, or ``pack_request`` keywords) one request
    at a time, and puts ``(k, [(status or kind, reply, seconds)])`` on
    ``results`` (``(k, error text)`` if it failed)."""
    import socket

    from rlgpuschedule_tpu_torch.serve import wire

    out = []
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s, \
                s.makefile("rb") as f:
            barrier.wait(timeout=120)
            for i, extra in zip(rows, extras):
                t0 = time.perf_counter()
                if framed:
                    s.sendall(wire.pack_request(obs[i], mask[i], **extra))
                    kind, header, body, meta64, _, rid = wire.recv_frame(s)
                    out.append((kind, (header, body, meta64, rid),
                                time.perf_counter() - t0))
                else:
                    s.sendall(_http_decide(obs[i], mask[i], extra))
                    status, headers, payload = _http_read(f)
                    out.append((status, (headers, payload),
                                time.perf_counter() - t0))
    except BaseException as e:          # the parent fails the phase
        barrier.abort()
        results.put((k, f"client {k}: {type(e).__name__}: {e}"))
        return
    results.put((k, out))


def _client_context():
    """The multiprocessing context of phase 22's clients: a fork server
    that imports the wire module once (started at the first call, in the
    background), so a client costs a fork, not an interpreter start."""
    import multiprocessing
    import multiprocessing.forkserver

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__",
                                "rlgpuschedule_tpu_torch.serve.wire"])
    multiprocessing.forkserver.ensure_running()
    return ctx


def _wire_clients(port, framed, obs, mask, rows, extras):
    """One client PROCESS per entry of ``rows`` (a list of row-index
    lists, ``extras`` alike), started together behind a barrier, so the
    clients do not share the server's interpreter. Returns each client's
    replies and the wall time from the barrier to the last reply; every
    process is joined (or terminated) before it returns. The processes
    fork from a fork server (never from this multi-threaded process,
    which holds the card) that imported the wire module once."""
    ctx = _client_context()
    n = len(rows)
    barrier = ctx.Barrier(n + 1)
    results = ctx.Queue()
    procs = [ctx.Process(target=_wire_client,
                         args=(k, port, framed, obs, mask, rows[k],
                               extras[k], barrier, results), daemon=True)
             for k in range(n)]
    for p in procs:
        p.start()
    try:
        barrier.wait(timeout=180)
        t0 = time.perf_counter()
        got = dict(results.get(timeout=600) for _ in range(n))
        wall = time.perf_counter() - t0
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    errors = [v for v in got.values() if isinstance(v, str)]
    if errors:
        raise SystemExit(f"front door clients failed: {errors}")
    return [got[k] for k in range(n)], wall


def _http_once(port, obs, mask) -> int:
    """One decide on a connection of its own; the status."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=60) as s, \
            s.makefile("rb") as f:
        s.sendall(_http_decide(obs, mask, ("Connection: close",)))
        return _http_read(f)[0]


def frontend_phase(torch, dev):
    """Phase 22: the network front door over config 2 on the card."""
    import socket
    import tempfile
    import threading

    import numpy as np

    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.experiment import (build_env_params,
                                                    build_policy)
    from rlgpuschedule_tpu_torch.obs import Registry
    from rlgpuschedule_tpu_torch.serve import (InferenceEngine,
                                               PolicyServer,
                                               ServerClosedError,
                                               build_request_pool,
                                               start_frontend, wire)
    from rlgpuschedule_tpu_torch.serve.fleet import fleet_windows

    smi = _nvidia_smi()
    _client_context()        # the clients' fork server imports meanwhile
    cfg = CONFIGS[CONFIG]
    env_params = build_env_params(cfg)
    policy = build_policy(cfg, env_params, device=dev)
    _, traces = fleet_windows(cfg, 64, device=dev)
    pool = build_request_pool(policy, env_params, traces, steps=4)
    del traces
    obs = np.stack([o for o, _ in pool])
    mask = np.stack([m for _, m in pool])
    with torch.no_grad():
        logits, _ = policy(torch.from_numpy(obs).to(dev),
                           torch.from_numpy(mask).to(dev))
        top2 = torch.topk(logits.float(), 2, -1).values.cpu().numpy()
    margin = top2[:, 0] - top2[:, 1]

    # (1) one engine, every bucket warmed on this thread; the in-process
    # actions of every pool row through the server, inline-pumped
    reg = Registry()
    engine = InferenceEngine(policy, max_bucket=256, device=dev,
                             registry=reg, strict=True)
    engine.warmup(obs[0], mask[0])
    server = PolicyServer(engine, registry=reg)
    futs = [server.submit(o, m) for o, m in pool]
    while server.pump():
        pass
    ref = np.array([int(f.result(timeout=60).action) for f in futs])
    server.start()
    handle = start_frontend(server, obs[0], mask[0], port=0)
    n = len(pool)

    # (2) 8 HTTP keep-alive clients, then 8 framed ones (one process
    # each), each FRONTEND_REQUESTS requests over real sockets; every
    # action against the in-process one for its row
    rows = [[(k * FRONTEND_REQUESTS + j) * 7 % n
             for j in range(FRONTEND_REQUESTS)]
            for k in range(FRONTEND_CLIENTS)]
    dialects = {}
    flips = {}
    for framed in (False, True):
        name = "framed" if framed else "http"
        rid0 = (1 << 40) * (2 if framed else 1)
        rids = [[rid0 + k * FRONTEND_REQUESTS + j
                 for j in range(FRONTEND_REQUESTS)]
                for k in range(FRONTEND_CLIENTS)]
        extras = [[{"req_id": r} if framed else (f"X-Request-Id: {r}",)
                   for r in ids] for ids in rids]
        out, wall = _wire_clients(handle.port, framed, obs, mask, rows,
                                  extras)
        lat, served_lat, flipped = [], [], 0
        for k, replies in enumerate(out):
            for j, (status, reply, secs) in enumerate(replies):
                i, rid = rows[k][j], rids[k][j]
                if framed:
                    header, body, micros, got_rid = reply
                    if status != wire.KIND_RESP or got_rid != rid:
                        raise SystemExit(f"framed request {rid}: kind "
                                         f"{status}, {header!r}")
                    action = int(wire.unpack_action(header, body).item())
                    served_lat.append(micros / 1e3)
                else:
                    headers, payload = reply
                    if status != 200 or payload["request_id"] != rid:
                        raise SystemExit(f"http request {rid}: {status} "
                                         f"{payload}")
                    action = payload["action"]
                    served_lat.append(payload["latency_ms"])
                if action != ref[i]:
                    if margin[i] >= MARGIN:
                        raise SystemExit(
                            f"{name}: row {i} served {action}, in process "
                            f"{ref[i]}, at a top-two margin {margin[i]} >= "
                            f"{MARGIN}")
                    flipped += 1
                lat.append(secs * 1e3)
        flips[name] = flipped
        dialects[name] = {
            "clients": FRONTEND_CLIENTS, "requests": len(lat),
            "decisions_per_s": len(lat) / wall, "wall_s": wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            # the server's own submit -> result share of each request
            "server_p50_ms": float(np.percentile(served_lat, 50)),
            "server_p99_ms": float(np.percentile(served_lat, 99)),
            "near_tie_flips": flipped}
    _line("frontend_traffic", card=smi, config=CONFIG, pool_rows=n,
          rows_below_margin=int((margin < MARGIN).sum()),
          dispatches=int(reg.counter("serve_dispatches_total").value),
          batch_occupancy_mean=server.slo_snapshot()[
              "batch_occupancy_mean"], **dialects)

    # (3) a deadline burst: 10 us deadlines, 50 requests on each of 4
    # connections of each dialect; every reply served or shed, the sheds
    # with a Retry-After in the band
    shed = {}
    for framed in (False, True):
        extra = {"deadline_s": 1e-5} if framed else ("X-Deadline-Ms: 0.01",)
        out, _ = _wire_clients(handle.port, framed, obs, mask,
                               [r[:50] for r in rows[:4]],
                               [[extra] * 50 for _ in range(4)])
        sheds, retries = 0, []
        for replies in out:
            for status, reply, _ in replies:
                if framed and status == wire.KIND_ERR:
                    header, _, meta64, _ = reply
                    if not header.startswith(b"shed:"):
                        raise SystemExit(f"burst: framed error {header!r}")
                    sheds += 1
                    retries.append(meta64 / 1e6)
                elif not framed and status == 503:
                    headers, payload = reply
                    if payload["error"] != "shed":
                        raise SystemExit(f"burst: http 503 {payload}")
                    sheds += 1
                    retries.append(float(headers["retry-after"]))
                elif status not in (200, wire.KIND_RESP):
                    raise SystemExit(f"burst: reply {status} {reply}")
        if not sheds or not all(0.01 <= r <= 30.0 for r in retries):
            raise SystemExit(f"burst: {sheds} sheds, Retry-After "
                             f"{min(retries, default=None)}-"
                             f"{max(retries, default=None)} s")
        shed["framed" if framed else "http"] = {
            "requests": 200, "shed": sheds,
            "retry_after_min_s": min(retries),
            "retry_after_max_s": max(retries)}

    # (4) the drain with idle keep-alive connections open: bounded, late
    # work refused with the typed error, every request accounted for
    idle = [socket.create_connection(("127.0.0.1", handle.port),
                                     timeout=30) for _ in range(4)]
    files = [s.makefile("rb") for s in idle]
    for s, f in zip(idle, files):
        s.sendall(_http_decide(obs[0], mask[0]))
        if _http_read(f)[0] != 200:
            raise SystemExit("front door: an idle client's decide failed")
    t0 = time.perf_counter()
    handle.drain(timeout=FRONTEND_DRAIN_BOUND_S)
    drain_s = time.perf_counter() - t0
    try:
        server.submit(obs[0], mask[0])
        raise SystemExit("a submit after the drain was accepted")
    except ServerClosedError:
        pass
    idle[0].sendall(_http_decide(obs[0], mask[0]))
    status, headers, payload = _http_read(files[0])
    eof = [f.readline() for f in files]      # refused, then lingered out
    for s, f in zip(idle, files):
        f.close()
        s.close()
    handle.close()
    submitted = reg.counter("serve_requests_total").value
    served = server.slo_snapshot()["requests"]
    shed_total = reg.counter("serve_shed_total").value
    errors = reg.counter("serve_dispatch_errors_total").value
    _line("frontend_contract", card=smi, shed_burst=shed,
          drain_s=drain_s, late_http=[status, payload["error"],
                                      headers["connection"]],
          submitted=int(submitted), served=served, shed=int(shed_total),
          dispatch_errors=int(errors), near_tie_flips=flips,
          recompiles=engine.post_warmup_recompiles,
          sync_debug_mode_after=torch.cuda.get_sync_debug_mode())
    if not (drain_s < FRONTEND_DRAIN_BOUND_S and status == 503
            and payload["error"] == "closed" and all(e == b"" for e in eof)
            and submitted == served + shed_total and errors == 0
            and engine.post_warmup_recompiles == 0
            and torch.cuda.get_sync_debug_mode() == 0):
        raise SystemExit("front door: the drain, conservation or the sync "
                         "guard failed")

    # (5) backpressure: a burst past a small high-water mark while no
    # dispatcher runs pauses the reads; the dispatcher then drains it
    breg = Registry()
    bserver = PolicyServer(engine, registry=breg)
    bhandle = start_frontend(bserver, obs[0], mask[0], port=0,
                             high_water=8, low_water=2)
    pauses = breg.counter("serve_frontend_backpressure_pauses_total")
    results = []
    clients = [threading.Thread(
        target=lambda k=k: results.append(_http_once(bhandle.port, obs[k],
                                                     mask[k])),
        daemon=True) for k in range(32)]
    for t in clients:
        t.start()
    deadline = time.monotonic() + 30
    while not pauses.value:
        if time.monotonic() > deadline:
            raise SystemExit("backpressure: the reads never paused")
        time.sleep(0.005)
    bserver.start()
    for t in clients:
        t.join(timeout=60)
    bhandle.close()
    bsubmitted = breg.counter("serve_requests_total").value
    _line("frontend_backpressure", card=smi, pauses=int(pauses.value),
          statuses=sorted(set(results)), resolved=len(results),
          submitted=int(bsubmitted), served=bserver.slo_snapshot()["requests"])
    if results != [200] * 32 or bsubmitted != 32:
        raise SystemExit(f"backpressure: {len(results)} of 32 resolved, "
                         f"{sorted(set(results))}")
    del engine, server, bserver, policy

    # (6) the CLI in one run: the front door around a soak with the
    # request spans, then the host path with its wire arms; the
    # post-mortem of one of its requests, and the run's alarms
    with tempfile.TemporaryDirectory() as d:
        lines, _, wall = _run_main(
            "rlgpuschedule_tpu_torch.serve.__main__",
            ["--config", CONFIG, "--bucket", "256", "--soak", "4",
             "--frontend-port", "0", "--obs-dir", d, "--trace-spans",
             "--host-path", "--wire-requests", str(FRONTEND_WIRE_REQUESTS)])
        (line,) = lines
        fe, sk, hp = line["frontend"], line["soak"], line["host_path"]
        rep, _, _ = _run_main(
            "rlgpuschedule_tpu_torch.obs.report",
            [d, "--request", str(fe["request_id"]), "--json"])
        _run_main("rlgpuschedule_tpu_torch.obs.report",
                  [d, "--strict-alarms"])
        stages = [s["stage"] for s in rep[0]["stages"]]
    legacy, arena = hp["arms"]
    http, framed = hp["wire_arms"]
    _line("frontend_cli", card=smi, wall_s=wall,
          decide_status=fe["decide_status"], late_submit=fe["late_submit"],
          post_drain_connect=fe["post_drain_connect"],
          soak_requests=sk["requests"], soak_served=sk["served"],
          soak_shed=sk["shed"], request_id=fe["request_id"],
          request_stages=stages, strict_alarms="clean")
    _line("frontend_host_path", card=smi, bucket=hp["bucket"],
          legacy_decisions_per_s=legacy["decisions_per_s"],
          arena_decisions_per_s=arena["decisions_per_s"],
          arena_alloc_calls=arena["alloc_calls"],
          http_decisions_per_s=http["decisions_per_s"],
          framed_decisions_per_s=framed["decisions_per_s"],
          wire_requests=[http["requests"], framed["requests"]],
          wire_served=[http["served"], framed["served"]],
          speedup=hp["speedup"], speedup_inproc=hp["speedup_inproc"])
    if ((fe["decide_status"], fe["late_submit"], fe["post_drain_connect"])
            != (200, "server-closed", "refused")
            or stages != ["enqueue", "served"]
            or sk["post_warmup_recompiles"] or sk["dispatch_errors"]):
        raise SystemExit(f"serve --frontend-port: {fe} {sk} {stages}")
    if arena["alloc_calls"] or not all(
            a["conservation_ok"] for a in hp["arms"] + hp["wire_arms"]):
        raise SystemExit(f"serve --host-path --wire-requests: {hp}")


def flywheel_phase(torch, dev):
    """Phase 23: the data flywheel over config 2 on the card."""
    import copy
    import shutil
    import tempfile

    import numpy as np

    from rlgpuschedule_tpu_torch.algos.action_dist import log_prob
    from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.experiment import (Experiment,
                                                    build_env_params,
                                                    build_policy)
    from rlgpuschedule_tpu_torch.flywheel import (FlightLogWriter,
                                                  read_flight_log,
                                                  read_ledger,
                                                  replay_decisions,
                                                  run_continual)
    from rlgpuschedule_tpu_torch.obs import Registry
    from rlgpuschedule_tpu_torch.serve import (InferenceEngine, PolicyServer,
                                               build_request_pool, run_soak)
    from rlgpuschedule_tpu_torch.serve.fleet import fleet_windows

    smi = _nvidia_smi()
    t_phase = time.perf_counter()
    cfg = CONFIGS[CONFIG]
    env_params = build_env_params(cfg)
    policy = build_policy(cfg, env_params, device=dev)
    _, traces = fleet_windows(cfg, 64, device=dev)
    pool = build_request_pool(policy, env_params, traces, steps=4)
    del traces
    obs = np.stack([o for o, _ in pool])
    mask = np.stack([m for _, m in pool])
    band = RHO_BAND["bfloat16"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_flywheel_")
    try:
        # (1) the capture graph against the plain one, bucket by bucket:
        # the same actions; its log-prob and value against the plain
        # PyTorch rule on the CPU (the ratio band of phase 17)
        plain = InferenceEngine(policy, max_bucket=256, device=dev,
                                strict=True)
        cap = InferenceEngine(policy, max_bucket=256, device=dev,
                              strict=True, capture=True)
        plain.warmup(obs[0], mask[0])
        cap.warmup(obs[0], mask[0])
        lat = {}
        for bucket, sizes in BUCKETS.items():
            for name, eng in (("plain", plain), ("capture", cap)):
                ts = []
                for r in range(LATENCY_REPS):
                    for k in sizes:
                        rows = (np.arange(k) * 7 + r) % len(pool)
                        t0 = time.perf_counter()
                        eng.decide(obs[rows], mask[rows])
                        ts.append((time.perf_counter() - t0) * 1e3)
                lat[f"{name}_p50_ms_{bucket}"] = float(np.percentile(ts, 50))
        cpu = copy.deepcopy(policy).to("cpu")
        rho_dev, v_dev, compared = 0.0, 0.0, 0
        for bucket, sizes in BUCKETS.items():
            for k in sizes:
                rows = np.arange(k) * 7 % len(pool)
                a_p, _ = plain.decide(obs[rows], mask[rows])
                (a_c, lp_c, v_c), b = cap.decide(obs[rows], mask[rows])
                if b != bucket or not np.array_equal(a_p, a_c):
                    raise SystemExit(f"capture at {k} rows (bucket {b}): "
                                     f"its actions differ from the plain "
                                     f"graph's")
                with torch.no_grad():
                    logits, value = cpu(torch.from_numpy(obs[rows]),
                                        torch.from_numpy(mask[rows]))
                    lp_ref = log_prob(logits, torch.from_numpy(a_c))
                rho = np.exp(lp_c.astype(np.float64)
                             - lp_ref.double().numpy())
                v_ref = value.double().numpy()
                rho_dev = max(rho_dev, abs(float(rho.mean()) - 1.0))
                v_dev = max(v_dev, float(np.abs(v_c - v_ref).max())
                            / max(1.0, float(np.abs(v_ref).max())))
                compared += k
        del cpu
        _line("flywheel_capture", card=smi, config=CONFIG,
              elapsed_s=time.perf_counter() - t_phase, **lat,
              rows_compared=compared, actions_equal=True,
              capture_vs_cpu_max_abs_rho_mean_minus_1=rho_dev,
              capture_vs_cpu_value_max_rel_diff=v_dev, band=band,
              recompiles=[plain.post_warmup_recompiles,
                          cap.post_warmup_recompiles])
        if rho_dev > band or v_dev > band:
            raise SystemExit(f"capture against the CPU: rho {rho_dev}, "
                             f"value {v_dev} leave the band {band}")

        # (2) the same soak without the flight log and with the durable
        # one, through the capture engine (the sync guard on in every
        # dispatch, the writer on the dispatcher thread), in FLY_ARMS'
        # order; each durable log is reloaded crc-verified, and the first
        # one feeds the rest of the phase
        runs = {"no_log": [], "durable_log": []}
        for i, arm in enumerate(FLY_ARMS):
            reg = Registry()
            flog = os.path.join(tmp, f"flog{i}")
            writer = (FlightLogWriter(flog, capacity=FLY_CAPACITY,
                                      registry=reg, durable=True)
                      if arm == "durable_log" else None)
            server = PolicyServer(cap, registry=reg, flight_log=writer)
            server.start()
            try:
                sk = run_soak(server, pool, duration_s=FLY_SOAK_S,
                              rate_hz=FLY_RATE, deadline_s=FLY_DEADLINE_S)
            finally:
                server.close()
            sk["dispatch_errors"] = int(
                reg.counter("serve_dispatch_errors_total").value)
            sk["decisions_per_s"] = sk["served"] / sk["duration_s"]
            if writer is not None:
                writer.close()
                data = read_flight_log(flog)
                rids = np.concatenate([s.req_id for s in data.shards])
                sk.update(log=flog, rows_logged=writer.rows_logged,
                          shards_sealed=writer.shards_sealed,
                          reloaded_rows=data.rows, torn_tail=data.torn_tail,
                          unique_req_ids=int(np.unique(rids).size))
                if (writer.rows_logged != sk["served"]
                        or data.rows != sk["served"] or data.torn_tail
                        or np.unique(rids).size != data.rows
                        or (rids == 0).any()):
                    raise SystemExit(f"flight log: {sk}")
            runs[arm].append(sk)
        first = runs["durable_log"][0]
        flog = first["log"]
        for sk in runs["durable_log"][1:]:
            shutil.rmtree(sk["log"])
        data = read_flight_log(flog)
        per_arm = ("requests", "served", "shed", "decisions_per_s",
                   "p99_first_half_ms", "p99_second_half_ms")
        _line("flywheel_soak", card=smi, config=CONFIG, rate_hz=FLY_RATE,
              duration_s=FLY_SOAK_S, deadline_ms=FLY_DEADLINE_S * 1e3,
              elapsed_s=time.perf_counter() - t_phase, order=FLY_ARMS,
              **{f"{arm}_{k}": [sk[k] for sk in sks]
                 for arm, sks in runs.items()
                 for k in per_arm + ("dispatch_errors",)},
              **{f"{arm}_median_{k}": float(np.median([sk[k] for sk in sks]))
                 for arm, sks in runs.items() for k in per_arm},
              rows_logged=[sk["rows_logged"] for sk in runs["durable_log"]],
              shards_sealed=[sk["shards_sealed"]
                             for sk in runs["durable_log"]],
              reloaded_rows=[sk["reloaded_rows"]
                             for sk in runs["durable_log"]],
              unique_req_ids=[sk["unique_req_ids"]
                              for sk in runs["durable_log"]],
              sync_debug_mode_after=torch.cuda.get_sync_debug_mode())
        if (any(sk["dispatch_errors"] for sks in runs.values()
                for sk in sks)
                or cap.post_warmup_recompiles
                or torch.cuda.get_sync_debug_mode() != 0):
            raise SystemExit(f"soaks: {runs}")

        # (3) train --continual's loop on the logged traffic, the
        # learner starting from the served weights
        exp = Experiment.build(cfg, device=dev)
        exp.net.load_state_dict(policy.state_dict())
        cand_dir = os.path.join(tmp, "cand")
        with Checkpointer(cand_dir, max_to_keep=FLY_ITERS) as ck:
            t0 = _sync(torch)
            cont = run_continual(exp, flog, iterations=FLY_ITERS,
                                 registry=Registry(), ckpt=ck)
            cont_s = _sync(torch) - t0
        means = [s["rho_mean"] for s in cont["per_shard"]]
        rho_mean_dev = max(abs(m - 1.0) for m in means)
        _line("flywheel_continual", card=smi, config=CONFIG,
              elapsed_s=time.perf_counter() - t_phase, wall_s=cont_s,
              iterations=FLY_ITERS, shards_seen=cont["shards_seen"],
              shards_refused=cont["shards_refused"],
              rows_trained=cont["rows_trained"],
              pseudo_steps=cont["pseudo_steps"],
              final_step=cont["final_step"],
              max_abs_shard_rho_mean_minus_1=rho_mean_dev,
              max_shard_rho_max=max(s["rho_max"]
                                    for s in cont["per_shard"]),
              rho_mean_trained=cont["rho_mean_trained"],
              rho_max_trained=cont["rho_max_trained"],
              total_loss=cont["total_loss"], band=band)
        if (cont["shards_refused"] or rho_mean_dev > band
                or not _finite(cont["total_loss"])):
            raise SystemExit(f"continual: {cont}")

        # (4) the canary's incumbent replay of the logged window: a row
        # it decides differently from the log must be a near tie. Every
        # logged row is a pool row, so the margins are the pool's
        window = data.concat()
        acts = window.act_leaves[0]
        at = {(o.tobytes(), m.tobytes()): i for i, (o, m) in enumerate(pool)}
        idx = np.array([at[o.tobytes(), m.tobytes()] for o, m in
                        zip(window.obs_leaves[0], window.mask_leaves[0])])
        obs_d, mask_d = torch.from_numpy(obs).to(dev), torch.from_numpy(
            mask).to(dev)
        with torch.no_grad():
            inc_margin = _top2_margin(torch, policy(obs_d, mask_d)[0])
            cand_margin = _top2_margin(torch, exp.net(obs_d, mask_d)[0])
        margin = inc_margin[idx]
        inc = replay_decisions(policy, policy.state_dict(),
                               window.obs_leaves[0], window.mask_leaves[0],
                               window.stall, env_params)[0]
        diff = inc != acts
        if (diff & (margin >= MARGIN)).any():
            raise SystemExit(f"canary: the incumbent replay differs from "
                             f"the log at a margin >= {MARGIN}")
        # what the retrain did to the seeded policy: its decisions, the
        # logits' top-two margins and the policy head's move, against the
        # log's outcome mix (the reward: +1, -1 when late)
        cnd = replay_decisions(policy, exp.net.state_dict(),
                               window.obs_leaves[0], window.mask_leaves[0],
                               window.stall, env_params)[0]
        n_act = int(mask.shape[-1])
        share = lambda a, n: (np.bincount(a, minlength=n) / a.size).tolist()
        inc_sd, cand_sd = policy.state_dict(), exp.net.state_dict()
        head = [k for k in inc_sd if k.startswith("policy.")]
        head_norm = lambda sd: float(torch.sqrt(sum(
            (sd[k].float() ** 2).sum() for k in head)))
        head_move = float(torch.sqrt(sum(
            ((cand_sd[k].float() - inc_sd[k].float()) ** 2).sum()
            for k in head)))
        del exp

        # (5) the serve CLI: a regressed candidate blocked, then the
        # retrained one promoted (the gate loosened, still run and
        # recorded), watched, rolled back by an injected fault
        base = ["--config", CONFIG, "--bucket", "256", "--flight-log", flog,
                "--durable-log"]
        lines, _, blk_wall = _run_main(
            "rlgpuschedule_tpu_torch.serve.__main__",
            base + ["--promote-noise", "0.5"])
        blk = lines[-1]["promote"]
        lines, _, pro_wall = _run_main(
            "rlgpuschedule_tpu_torch.serve.__main__",
            base + ["--promote", cand_dir, "--canary-tol", "1.0",
                    "--promote-fault"])
        pro = lines[-1]["promote"]
        sealed, tail = read_ledger(flog)
        actions = [e["action"] for e in sealed]
        _line("flywheel_promotion", card=smi, config=CONFIG,
              elapsed_s=time.perf_counter() - t_phase,
              window_rows=window.rows, incumbent_disagreements=int(
                  diff.sum()), near_tie_rows=int((margin < MARGIN).sum()),
              outcome_share=share(window.outcome.astype(np.int64), 3),
              log_action_share=share(acts.astype(np.int64), n_act),
              retrained_action_share=share(cnd.astype(np.int64), n_act),
              retrained_log_agreement=float((cnd == acts).mean()),
              pool_median_margin=[float(np.median(inc_margin)),
                                  float(np.median(cand_margin))],
              policy_head_norm=head_norm(inc_sd),
              policy_head_move=head_move,
              blocked_verdict=blk["verdict"],
              blocked_candidate_agreement=blk["canary"][
                  "candidate_agreement"],
              blocked_streak=blk["canary"]["max_regress_streak"],
              blocked_cli_wall_s=blk_wall, promoted_candidate=pro[
                  "candidate"], promoted=pro["promoted"],
              promoted_candidate_agreement=pro["canary"][
                  "candidate_agreement"],
              probe_rows_changed=pro.get("probe_rows_changed"),
              swap_recompiles=pro.get("swap_recompiles"),
              rollback=pro["rollback"],
              rollback_reasons=pro.get("rollback_reasons"),
              probe_bit_identical=pro.get("probe_bit_identical"),
              post_warmup_recompiles=pro.get("post_warmup_recompiles"),
              promote_cli_wall_s=pro_wall, ledger=actions,
              ledger_tail=len(tail))
        # the rollback must restore decisions the swap really changed
        if (blk["verdict"] != "blocked" or not pro["promoted"]
                or not pro["candidate"].endswith(f"@{cont['final_step']}")
                or not pro["canary"]["candidate_agreement"] < 1.0
                or not pro["probe_rows_changed"]
                or pro["swap_recompiles"] != 0 or not pro["rollback"]
                or pro["probe_bit_identical"] is not True
                or pro["post_warmup_recompiles"] != 0
                or actions != ["blocked", "promote", "rollback"] or tail):
            raise SystemExit(f"promotion: blocked {blk}, promoted {pro}, "
                             f"ledger {actions} + {len(tail)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _events(obs_dir: str) -> list[dict]:
    from rlgpuschedule_tpu_torch.obs import merge_dir
    return merge_dir(obs_dir)


def telemetry_phase(torch, dev, beside=None):
    """Phase 24: the run-loop observability of config 1 on the card.
    ``beside(torch, dev)``, work that checks bits and not time, runs in
    this process while the children run (it would only wait otherwise)."""
    import io
    import shutil
    import tempfile

    from rlgpuschedule_tpu_torch.obs import report as report_cli

    from rlgpuschedule_tpu_torch.bench import card_info
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.experiment import Experiment
    from rlgpuschedule_tpu_torch.obs import (AlarmError, Alarms, EventBus,
                                             Registry)
    from rlgpuschedule_tpu_torch.profile_breakdown import BF16_PEAK
    from rlgpuschedule_tpu_torch.serve import InferenceEngine
    from rlgpuschedule_tpu_torch.utils import profiling

    smi = _nvidia_smi()
    name, limit = card_info()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    procs = {}
    try:
        d = {k: os.path.join(tmp, k) for k in
             ("clean", "slow", "matrix", "alarms", "trace")}
        # (5b) the minibatch sweep at a cut width, alone on the card (in
        # this process, under torch's default switches, as the CLI runs)
        sweep = os.path.join(tmp, "sweep.json")
        _, art, sweep_wall = _run_main(BREAKDOWN, [
            "--sweep-minibatch", "--n-envs", SWEEP_GEOMETRY[0],
            "--n-steps", SWEEP_GEOMETRY[1], "--repeats", "1",
            "--iters-per-repeat", "1", "--sweep-out", sweep])
        best = art["best"]
        times = [r["update_s_per_iteration"] for r in art["results"]]
        if times != sorted(times) or best != art["results"][0]:
            raise SystemExit(f"sweep not ranked fastest first: {times}")
        # then side by side, as no wall or rate of theirs is kept: the
        # bench fed the sweep, (1) and (2) the train CLI, (4) the matrix
        train = ["--config", BENCH_CONFIG, "--iterations", str(OBS_ITERS),
                 "--log-every", "1", "--alarms"]
        procs.update({
            # on the host CPU: it checks the geometry the bench reads
            # (phase 18 runs the bench on the card); on 2 threads, as its
            # small operations gain nothing from more and the children
            # beside it share the host's cores
            "bench": _spawn("rlgpuschedule_tpu_torch.bench",
                            ["--sweep", sweep, "--device", "cpu"],
                            env={"OMP_NUM_THREADS": "2"}),
            "clean": _spawn("rlgpuschedule_tpu_torch.train", [
                *train, "--obs-dir", d["clean"], "--trace-spans",
                "--log-csv", os.path.join(tmp, "m.csv"),
                "--tb-dir", os.path.join(tmp, "tb")]),
            "slow": _spawn("rlgpuschedule_tpu_torch.train", [
                *train, "--obs-dir", d["slow"],
                "--alarm-slow-iter", str(OBS_SLOW_S)]),
            "matrix": _spawn("rlgpuschedule_tpu_torch.evaluate", [
                "--config", BENCH_CONFIG, "--matrix", "--obs-dir",
                d["matrix"], "--alarms"]),
        })
        # (3) an Alarms scope in this process: the warm control and a
        # forced read under the guard, then a bucket never captured
        exp = Experiment.build(CONFIGS[BENCH_CONFIG], device=dev)
        obs = exp.carry.obs.cpu().numpy()
        mask = exp.carry.mask.cpu().numpy()
        engine = InferenceEngine(exp.net, max_bucket=4, device=dev)
        engine.warmup(obs[0], mask[0], buckets=(1, 2))
        bus = EventBus(d["alarms"], rank=0, name="alarms")
        caught = None
        with Alarms(bus, Registry(), device=dev) as al:
            with al.dispatch(0):
                engine.decide(obs[:1], mask[:1])          # the warmup
            with al.dispatch(1):
                engine.decide(obs[:2], mask[:2])          # warm control
            x = torch.ones(3, device=dev)
            try:
                with al.dispatch(2):
                    float(x.sum().item())
            except AlarmError as e:
                caught = str(e)
        with Alarms(bus, Registry(), transfer_guard=False, device=dev) as al:
            with al.dispatch(0):
                engine.decide(obs[:1], mask[:1])
            with al.dispatch(1):
                engine.decide(obs[:3], mask[:3])          # bucket 4: new
        bus.close()
        kinds = [e["kind"] for e in _events(d["alarms"])]
        if caught is None or kinds.count("transfer") != 1 \
                or kinds.count("recompile") != 1:
            raise SystemExit(f"alarm scope on the card: AlarmError "
                             f"{caught is not None}, events {kinds}")
        # (6) --debug-nans: a clean iteration passes (a cut rollout: every
        # operation reads back), a NaN weight raises
        del engine
        cut = CONFIGS[BENCH_CONFIG]
        cut = dataclasses.replace(cut, ppo=dataclasses.replace(
            cut.ppo, n_steps=OBS_NAN_STEPS))
        exp = Experiment.build(cut, device=dev)
        with profiling.debug_checks():
            exp.run(1)
        with torch.no_grad():
            next(exp.net.parameters()).view(-1)[0] = float("nan")
        nan_error = None
        try:
            with profiling.debug_checks():
                exp.run(1)
        except FloatingPointError as e:
            nan_error = str(e)
        if nan_error is None:
            raise SystemExit("--debug-nans: a NaN weight did not raise")
        del exp
        if beside is not None:
            beside(torch, dev)

        t0 = time.perf_counter()
        done = _reap_all(procs)
        reap_wait = time.perf_counter() - t0
        bench = done["bench"][0][-1]
        geom = bench["geometry"]
        if (geom["n_epochs"], geom["n_minibatches"]) != (
                best["n_epochs"], best["n_minibatches"]):
            raise SystemExit(f"bench --sweep ran {geom}, the sweep's best "
                             f"is {best}")
        with contextlib.redirect_stdout(io.StringIO()):
            rcs = {k: report_cli.main([d[k], "--strict-alarms"])
                   for k in ("clean", "slow", "matrix")}
        if rcs != {"clean": 0, "slow": 1, "matrix": 0}:
            raise SystemExit(f"obs.report --strict-alarms exit codes {rcs} "
                             f"(want clean 0, slow 1, matrix 0)")
        ev = {k: _events(d[k]) for k in ("clean", "slow", "matrix")}
        count = {k: {kind: sum(e["kind"] == kind for e in es)
                     for kind in ("iteration", "compile", "recompile",
                                  "transfer", "slow_iteration",
                                  "profile_captured", "span_begin")}
                 for k, es in ev.items()}
        prom = open(os.path.join(d["clean"], "metrics.prom")).read()
        with open(os.path.join(tmp, "m.csv")) as f:
            csv_rows = len(f.read().splitlines()) - 1
        tb_bytes = sum(os.path.getsize(os.path.join(tmp, "tb", f))
                       for f in os.listdir(os.path.join(tmp, "tb")))
        profiles = sorted(os.listdir(os.path.join(d["slow"], "profile")))
        kernel_events = 0
        if len(profiles) == 1:
            with open(os.path.join(d["slow"], "profile", profiles[0]),
                      "rb") as f:
                kernel_events = f.read().count(KERNEL_EVENT)
        walls = [e["wall_s"] for e in ev["slow"]
                 if e["kind"] == "iteration"]
        c, sl = count["clean"], count["slow"]
        if c["iteration"] != OBS_ITERS or c["recompile"] or c["transfer"] \
                or not c["span_begin"] \
                or f"rlsched_iterations_total {OBS_ITERS}" not in prom \
                or csv_rows != OBS_ITERS or not tb_bytes:
            raise SystemExit(f"train --obs-dir --alarms: {c}, csv rows "
                             f"{csv_rows}, tensorboard bytes {tb_bytes}")
        if not sl["slow_iteration"] or sl["profile_captured"] != 1 \
                or len(profiles) != 1 or not kernel_events \
                or min(walls) <= OBS_SLOW_S:
            raise SystemExit(f"--alarm-slow-iter: {sl}, profiles "
                             f"{profiles}, kernel events {kernel_events}")
        if count["matrix"]["recompile"] or count["matrix"]["transfer"]:
            raise SystemExit(f"evaluate --matrix --alarms: "
                             f"{count['matrix']}")
        _line("obs_alarms", card=name, power_limit=limit, counts=count,
              report_exit_codes=rcs, csv_rows=csv_rows,
              tensorboard_bytes=tb_bytes, profile_kernel_events=kernel_events,
              slow_iteration_walls_s=walls, alarm_scope_events=kinds,
              alarm_error=caught[:160], debug_nans_error=nan_error[:160],
              child_walls_s={k: v[2] for k, v in done.items()},
              reap_wait_s=reap_wait)
        _line("obs_sweep", card=name, power_limit=limit,
              geometry=SWEEP_GEOMETRY, best=best, geometries=len(times),
              sweep_wall_s=sweep_wall, bench_geometry=geom,
              # the bench ran on the host beside the CLIs: a check only
              bench_device=bench["metric"])

        # (5) the stage breakdown at 512 x 128, alone on the card
        # (3 calls a window, the tool's default: with one, the loop and
        # the blocked step would time the same thing)
        _, art, wall = _run_main(BREAKDOWN, [
            "--n-envs", BREAKDOWN_GEOMETRY[0], "--n-steps",
            BREAKDOWN_GEOMETRY[1], "--repeats", "1", "--trace-dir",
            d["trace"]])
        sec = art["seconds_per_iteration"]
        span = art["device_span_ms_per_iteration"]
        busy = art["device_busy_ms_per_iteration"]
        traces = os.listdir(d["trace"])
        if [str(art["n_envs"]), str(art["n_steps"])] != \
                list(BREAKDOWN_GEOMETRY) or len(traces) != 1 \
                or art["iters_per_repeat"] < 3 \
                or any(v is None for v in span.values()) \
                or not all(v and v > 0 for v in busy.values()) \
                or (name in BF16_PEAK and art["mfu_update"] is None):
            raise SystemExit(f"profile_breakdown: {art}, traces {traces}")
        _line("obs_breakdown", card=name, power_limit=limit,
              n_envs=art["n_envs"], n_steps=art["n_steps"],
              geometry=art["geometry"],
              iters_per_repeat=art["iters_per_repeat"],
              seconds_per_iteration=sec, device_span_ms_per_iteration=span,
              device_busy_ms_per_iteration=busy,
              device_busy_share=art["device_busy_share"],
              sum_of_parts_s=sec["rollout"] + sec["advantage"]
              + sec["update"], fused_loop_s=sec["fused_loop"],
              parts_over_fused_loop=art["parts_over_fused_loop"],
              env_steps_per_sec=art["env_steps_per_sec"],
              mfu_total=art["mfu_total"], mfu_update=art["mfu_update"],
              trace_mb=os.path.getsize(os.path.join(d["trace"], traces[0]))
              / 2 ** 20, wall_s=wall)
    finally:
        _kill(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    _line("obs_phase", card=name, power_limit=limit, smi=smi,
          wall_s=time.perf_counter() - t_phase)



def _async_snapshot(exp) -> dict:
    """Clones of what an experiment or a population carries after a run:
    every policy's parameters and optimizer state, every carry, both
    generators of each member, and the host state (window cursor,
    iteration, hyperparameters, PBT decisions)."""
    pop = hasattr(exp, "members")
    nets = ([(m.net, m.opt) for m in exp.members] if pop
            else [(exp.net, exp.train_state.opt)])
    carries = exp.carries if pop else [exp.carry]
    gens = exp.generators if pop else [exp.generator]
    host = {"iteration": exp.iteration}
    if pop:
        host.update(hparams=[x.tolist() for x in exp.hparams],
                    decisions=[(d.src.tolist(), d.exploited.tolist())
                               for d in exp.controller.history])
    else:
        host["window_cursor"] = exp.window_cursor
    return {
        "tensors": [t.detach().clone() for t in _tensors(
            [(n.state_dict(), o.state_dict()["state"]) for n, o in nets]
            + [(c.env_state, c.obs, c.mask) for c in carries])],
        "generators": [g.get_state().clone() for g in
                       [c.generator for c in carries] + list(gens)],
        "host": host}


def _async_differing(torch, a: dict, b: dict) -> dict:
    """Differing elements of two :func:`_async_snapshot`s (all 0: bit
    for bit), and the largest absolute difference among them."""
    xs, ys = a["tensors"], b["tensors"]
    if len(xs) != len(ys):
        return {"tensors": math.inf, "max_abs": math.inf,
                "generators": len(a["generators"]), "host": 1}
    n, worst = 0, 0.0
    for x, y in zip(xs, ys):
        ne = x != y
        n += int(ne.sum())
        if ne.any() and x.is_floating_point():
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return {"tensors": n, "max_abs": worst,
            "generators": sum(not torch.equal(u, v) for u, v in
                              zip(a["generators"], b["generators"])),
            "host": int(a["host"] != b["host"])}


def async_identity_phase(torch, dev):
    """Phase 25 (a) and (d), which check bits, not time: the async engine
    at bound 0 against the sync loops. Phase 24 runs them in this process
    while its children run (it would only wait for them otherwise)."""
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.experiment import (Experiment,
                                                    PopulationExperiment)
    from rlgpuschedule_tpu_torch.parallel import PBTConfig

    t_phase = time.perf_counter()
    # deterministic cuDNN on both arms: bit identity is about the engine,
    # not the convolution algorithms' run-to-run freedom
    old = _flags(torch, tf32=True, deterministic=True)
    try:
        # (a) config 2 at its preset width: sync against bound 0 across
        # one resample barrier
        cfg = dataclasses.replace(CONFIGS[CONFIG],
                                  resample_every=ASYNC_RESAMPLE)
        ref = Experiment.build(cfg, device=dev)
        ref.run(ASYNC_ITERS)
        exp = Experiment.build(cfg, device=dev)
        out = exp.run_async(ASYNC_ITERS, staleness_bound=0)
        diff = _async_differing(torch, _async_snapshot(ref),
                                _async_snapshot(exp))
        band = None
        if any(v for k, v in diff.items()):
            c = Experiment.build(cfg, device=dev)
            c.run(ASYNC_ITERS)
            band = _async_differing(torch, _async_snapshot(ref),
                                    _async_snapshot(c))
        _line("async_bound0", config=cfg.name, n_envs=cfg.n_envs,
              n_steps=cfg.ppo.n_steps,
              iterations=ASYNC_ITERS, resample_every=ASYNC_RESAMPLE,
              window_cursor=exp.window_cursor, differing=diff,
              sync_run_to_run=band,
              staleness_max=out["async"]["staleness_max"])
        if any(v for v in diff.values()) or exp.window_cursor != cfg.n_envs:
            raise SystemExit(f"run_async at bound 0 differs from run: "
                             f"{diff} (sync run to run: {band})")
        del ref, exp

        # (d) a population of 2 config-1 members: sync against bound 0
        pcfg = CONFIGS[BENCH_CONFIG]
        pcfg = dataclasses.replace(pcfg, ppo=dataclasses.replace(
            pcfg.ppo, n_steps=ASYNC_POP_STEPS))

        def pop():
            return PopulationExperiment.build(
                pcfg, n_pop=ASYNC_POP, device=dev,
                pbt_cfg=PBTConfig(ready_iters=ASYNC_POP_READY,
                                  seed=pcfg.seed))

        a = pop()
        a.run(ASYNC_POP_ITERS)
        b = pop()
        pout = b.run_async(ASYNC_POP_ITERS, staleness_bound=0)
        pdiff = _async_differing(torch, _async_snapshot(a),
                                 _async_snapshot(b))
        _line("async_population", n_pop=ASYNC_POP, n_steps=ASYNC_POP_STEPS,
              iterations=ASYNC_POP_ITERS, ready_iters=ASYNC_POP_READY,
              pbt_events=pout["pbt_events"], differing=pdiff,
              staleness_max_per_member=pout["async"][
                  "staleness_max_per_member"])
        if any(pdiff.values()) or pout["pbt_events"] != \
                ASYNC_POP_ITERS // ASYNC_POP_READY:
            raise SystemExit(f"async population at bound 0: {pdiff}, "
                             f"{pout['pbt_events']} PBT rounds")
        del a, b
    finally:
        _restore_flags(torch, old)
    _line("async_identity_phase", wall_s=time.perf_counter() - t_phase)


def async_phase(torch, dev):
    """Phase 25 (b), (c) and (e): the async actor-learner engine on the
    card ((a) and (d) run in phase 24: :func:`async_identity_phase`)."""
    import shutil
    import tempfile

    from rlgpuschedule_tpu_torch.async_engine import AsyncRunner
    from rlgpuschedule_tpu_torch.bench import card_info
    from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.experiment import Experiment
    from rlgpuschedule_tpu_torch.obs import (RunTelemetry,
                                             async_overlap_summary)
    from rlgpuschedule_tpu_torch.utils import profiling

    smi = _nvidia_smi()
    name, limit = card_info()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_async_")
    try:
        # (b) config 1 at 512 x 128, bound 1, traced and alarmed
        bcfg = CONFIGS[BENCH_CONFIG]
        bcfg = dataclasses.replace(
            bcfg, n_envs=BENCH_GEOMETRY["n_envs"],
            ppo=dataclasses.replace(
                bcfg.ppo, **{k: v for k, v in BENCH_GEOMETRY.items()
                             if k != "n_envs"}))
        exp = Experiment.build(bcfg, device=dev)
        runner = AsyncRunner(exp, staleness_bound=1)
        obs_dir = os.path.join(tmp, "obs")
        with RunTelemetry(obs_dir, alarms=True, trace=True,
                          device=dev) as tel:
            out = runner.run(ASYNC_TEL_ITERS, log_every=1, telemetry=tel)
        ev = _events(obs_dir)
        kinds = [e["kind"] for e in ev]
        overlap = async_overlap_summary(ev)
        info = out["async"]
        # one profiled window: each card stream's busy ms and their overlap
        iv = profiling.device_intervals(
            lambda: runner.run(ASYNC_PROFILE_ITERS), 1, dev)
        streams: dict = {}
        for lo, hi, stream in iv:
            streams.setdefault(stream, []).append((lo, hi))
        busy = {str(k): profiling.covered_ns(v) / 1e6
                for k, v in streams.items()}
        union = profiling.covered_ns((lo, hi) for lo, hi, _ in iv) / 1e6
        both = sum(busy.values()) - union
        _line("async_bound1", card=name, power_limit=limit,
              config=bcfg.name, n_envs=bcfg.n_envs,
              n_steps=bcfg.ppo.n_steps, iterations=ASYNC_TEL_ITERS,
              staleness_max=info["staleness_max"],
              staleness_mean=info["staleness_mean"],
              overlap_s=info["overlap_s"],
              actor_busy_s=info["actor_busy_s"],
              learner_busy_s=info["learner_busy_s"],
              actor_idle_s=info["actor_idle_s"],
              learner_idle_s=info["learner_idle_s"],
              async_overlap_measured=(overlap or {}).get(
                  "async_overlap_measured"),
              transfer_alarms=kinds.count("transfer"),
              recompile_alarms=kinds.count("recompile"),
              env_steps_per_sec=out["env_steps_per_sec"],
              profiled_iterations=ASYNC_PROFILE_ITERS,
              stream_busy_ms=busy, busy_ms=union, stream_overlap_ms=both,
              stream_overlap_share=both / union if union else None)
        if kinds.count("transfer") or kinds.count("recompile") \
                or info["staleness_max"] > 1 or overlap is None \
                or len(busy) < 2:
            raise SystemExit(f"async bound 1: events {sorted(set(kinds))}"
                             f", {info}, overlap {overlap}, streams {busy}")
        del exp, runner

        # (c) bound 4 with V-trace through the train CLI's main: the
        # update made the longer phase, so the queue runs deep
        ck = os.path.join(tmp, "ckpt")
        lines, summary, wall = _run_main("rlgpuschedule_tpu_torch.train", [
            "--config", BENCH_CONFIG, "--async", "--staleness-bound", "4",
            "--queue-capacity", "4", "--correction", "vtrace",
            "--iterations", str(ASYNC_DEEP_ITERS), "--log-every", "1",
            "--ckpt-dir", ck, "--ckpt-every", str(ASYNC_DEEP_ITERS // 2),
            *ASYNC_DEEP_GEOMETRY])
        rows = lines[:-1]
        with Checkpointer(ck) as c:
            meta = c.read_meta()
        info = summary["async"]
        losses = [r["total_loss"] for r in rows]
        _line("async_deep", card=name, power_limit=limit,
              geometry=ASYNC_DEEP_GEOMETRY, iterations=ASYNC_DEEP_ITERS,
              staleness_max=info["staleness_max"],
              staleness_mean=info["staleness_mean"],
              rho_mean=info["importance_ratio_mean"],
              rho_max=info["importance_ratio_max"], losses=losses,
              ckpt_meta={k: meta.get(k) for k in
                         ("iteration", "async_iteration",
                          "staleness_bound")}, wall_s=wall)
        if info["staleness_max"] <= 1 or not _finite(*losses) \
                or len(rows) != ASYNC_DEEP_ITERS \
                or meta.get("staleness_bound") != 4 \
                or meta.get("async_iteration") != ASYNC_DEEP_ITERS - 1:
            raise SystemExit(f"async bound 4: {info}, losses {losses}, "
                             f"checkpoint meta {meta}")

        # (e) bench --async --staleness-bound 1 through its main: a ratio
        # inside one process (its rates are not phase 18's)
        lines, line, wall = _run_main(
            "rlgpuschedule_tpu_torch.bench",
            ["--async", "--staleness-bound", "1", "--repeats",
             str(ASYNC_BENCH_REPEATS)])
        print(json.dumps(line), flush=True)
        _line("async_bench", card=name, power_limit=limit,
              sync_env_steps_per_sec=line[
                  "sync_env_steps_per_sec_per_chip"],
              async_env_steps_per_sec=line[
                  "async_env_steps_per_sec_per_chip"],
              speedup=line["speedup"],
              projected_overlap_speedup=line["projected_overlap_speedup"],
              async_overlap_measured=line["async_overlap_measured"],
              staleness_max=line["staleness_max"], wall_s=wall,
              note="rates inside this process: not phase 18's")
        if not (line["metric"] == "async_actor_learner_speedup[cuda]"
                and _finite(line["speedup"]) and line["power_limit"]):
            raise SystemExit(f"bench --async: {line}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _line("async_phase", card=name, power_limit=limit, smi=smi,
          wall_s=time.perf_counter() - t_phase)


def decide_latency(torch, tree: str) -> dict:
    """Graph ``decide`` latency (ms) of one tree's engine: config 2 at
    full width (bf16, seeded), phase 13's sizes, 300 calls a bucket; and
    phase 13's host-path bench (decisions/s of both data planes over the
    stub engine, bucket 256) on the same pool; one JSON line. Compares
    trees on one card, one process per run (the tree's package must be
    the one imported)::

        python3 -c "import sys, torch; sys.path.insert(0, '.');
            import chip_smoke as cs; cs.decide_latency(torch, TREE)"
    """
    import numpy as np

    sys.path.insert(0, os.path.abspath(tree))
    import rlgpuschedule_tpu_torch
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.experiment import (build_env_params,
                                                    build_policy)
    from rlgpuschedule_tpu_torch.serve import (InferenceEngine,
                                               build_request_pool,
                                               run_host_path)
    from rlgpuschedule_tpu_torch.serve.fleet import fleet_windows

    if not rlgpuschedule_tpu_torch.__file__.startswith(
            os.path.abspath(tree)):
        raise SystemExit(f"imported {rlgpuschedule_tpu_torch.__file__}, "
                         f"not {tree}'s package")
    cfg = CONFIGS[CONFIG]
    env_params = build_env_params(cfg)
    policy = build_policy(cfg, env_params, device="cuda")
    _, traces = fleet_windows(cfg, 64, device="cuda")
    pool = build_request_pool(policy, env_params, traces, steps=4)
    obs = np.stack([o for o, _ in pool])
    mask = np.stack([m for _, m in pool])
    engine = InferenceEngine(policy, max_bucket=256, device="cuda")
    engine.warmup(obs[0], mask[0])
    out = {"tree": tree}
    for bucket, sizes in BUCKETS.items():
        lat = []
        for _ in range(100):
            for n in sizes:
                rows = np.arange(n) * 7 % obs.shape[0]
                o, m = obs[rows], mask[rows]
                t0 = time.perf_counter()
                engine.decide(o, m)
                lat.append((time.perf_counter() - t0) * 1e3)
        out[f"p50_{bucket}"] = float(np.percentile(lat, 50))
        out[f"p99_{bucket}"] = float(np.percentile(lat, 99))
    hp = run_host_path(pool, max_bucket=256, rounds=HOST_ROUNDS)
    for arm in hp["arms"]:
        out[f"host_{arm['data_plane']}_decisions_per_s"] = arm[
            "decisions_per_s"]
    _line("decide_latency", **out)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.experiment import build_env_params
    from rlgpuschedule_tpu_torch.serve.fleet import fleet_windows

    t_start = time.perf_counter()
    smi = _nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": []}), flush=True)

    cfg = CONFIGS[CONFIG]
    env_params = build_env_params(cfg)
    windows, traces = fleet_windows(cfg, N_CLUSTERS, device="cuda")
    policy = fleet_phase(torch, cfg, env_params, traces, "cuda")
    profile_phase(torch, env_params, traces, policy)
    compare_phase(torch, cfg, env_params, windows, "cuda")
    eager_latency = request_phase(torch, env_params, traces, policy, "cuda")
    del policy, traces, windows

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(torch, "cuda", *args)
        _line("phase_time", phase=phase.__name__,
              wall_s=time.perf_counter() - t0)
        return out

    trained = timed(train_phase)
    timed(bench_phase)
    timed(train_compare_phase)
    held_out = timed(eval_phase, trained)
    del trained
    timed(eval_compare_phase, held_out)
    timed(entry_point_phase)
    timed(action_space_phase)
    timed(preset_train_eval_phase)
    timed(policy_server_phase, eager_latency)
    timed(checkpoint_phase)
    timed(select_phase)
    timed(fair_phase)
    timed(options_phase)
    timed(fused_phase)
    timed(hier_pbt_phase)
    timed(router_phase)
    timed(chaos_phase)
    timed(frontend_phase)
    timed(flywheel_phase)
    timed(telemetry_phase, async_identity_phase)
    timed(async_phase)
    _line("done", total_s=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
