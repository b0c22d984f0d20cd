"""Trace replay and the JCT-vs-baselines table (L6) of the port.

Counterpart of ``EvalResult``, ``replay``, ``full_trace_replay``,
``pooled_avg_jct``, ``baseline_jcts``, ``baseline_jct_table``,
``jct_report``, ``full_trace_report``, ``format_report``, the fairness
table (``jain_index``, ``fairness_report``, ``format_fairness``) and the
chaos and generalization matrices (``chaos_report``, ``format_chaos``,
``matrix_report``, ``format_matrix``) in the JAX package's
``eval.py``. There the replay is one ``lax.scan`` (a matrix cell one
jitted ``_matrix_cell``, so every cell shares a compiled program);
here it is a Python loop over decision steps whose
body stays on the device: no value comes back to the host inside the
loop, except one "all done?" check every 64 steps that ends the loop
early (a finished cluster is frozen, so the steps it skips would change
nothing). That check is an intended read
(``analysis.sentinels.intended_sync``): it passes the sync guard of the
matrix cells' alarms, where any other sync raises.

The policy side plays greedily (argmax over the masked logits) or as
the masked-uniform random control, optionally gated to
FIFO-with-backfill while the backlog is shallow (``backlog_gate``); on
a preemptive action space the greedy replay runs the stall guard
(``stall_guard``). The baseline side replays the same windows on the
host through :mod:`.sim.schedulers` (the native engine unless no
compiler is present), so the table compares like with like.

The full-trace replay stitches a whole source trace through E=1
windows of a fixed-shape job table, carrying every job not yet done
from one window to the next (:func:`full_trace_replay`).

The hierarchical env of config 5 (:class:`.env.hier.HierParams`)
replays per window through the same loop (:class:`_EnvOps` holds what
differs: the step, the capacity, the busy GPUs, the JCT statistics and
the makespan); its baselines run on the flat cluster, which gives them
more placement freedom than the pods have. Its percentiles, backlog
gate, stitched full-trace replay and fairness table are refused, as in
JAX.

Faults (flat configs): :func:`replay` and :func:`full_trace_replay`
take the fault or domain schedules of :mod:`.sim.faults` and
:mod:`.domains` (batched per window, or one global-time schedule that
each stitched window sees rebased onto its clock), and the baselines run
the same schedules on the Python oracle. :func:`chaos_report` is the
fault regime x scheduler matrix of ``evaluate --chaos``, and
:func:`matrix_report` the train regime x eval regime generalization
matrix of ``evaluate --matrix``; each holds every cell to the
no-job-lost conservation contract (:func:`_chaos_conservation`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from .algos import action_dist
from .algos.update import tree_map
from .analysis.sentinels import intended_sync
from .decision import (gate_stalled, greedy_actions, preempt_slice,
                       stall_threshold)
from .device import resolve_device
from .env import env as env_lib
from .env import hier as hier_lib
from .env.env import EnvParams, stack_traces
from .env.hier import HierParams
from .sim import core
from .sim.core import DONE, NOT_ARRIVED, PENDING, RUNNING
from .sim.faults import stack_fault_schedules
from .sim.schedulers import BASELINES, resolve_backend, run_baseline
from .traces.records import ArrayTrace

_DONE_CHECK_EVERY = 64
BASELINE_NAMES = tuple(BASELINES)   # fifo, sjf, srtf, tiresias
# the random control's generator seed (JAX draws it from PRNGKey(1); the
# two streams differ, so the rows agree in distribution only)
RANDOM_SEED = 1


class EvalResult(NamedTuple):
    """Per-cluster replay outcome (device tensors, ``[E]``)."""
    avg_jct: torch.Tensor      # f32 mean JCT over completed jobs
    n_done: torch.Tensor       # i32 completed valid jobs
    n_valid: torch.Tensor      # i32 valid jobs in the window
    makespan: torch.Tensor     # f32 final sim clock
    utilization: torch.Tensor  # f32 time-averaged GPU busy fraction
    steps: torch.Tensor        # i32 decision steps taken


class ReplayRecord(NamedTuple):
    """What the policy did at every step of a replay (``[T, E]``).
    Steps at and after a cluster's ``steps`` act on its frozen state."""
    actions: torch.Tensor   # the action taken (after any backlog gate)
    margin: torch.Tensor    # f32 top-1 minus top-2 of the deciding logits
    gated: torch.Tensor     # bool: the stall guard masked a legal preempt


def _random_actions(generator: torch.Generator, mask):
    """Masked-uniform actions drawn from ``generator`` (on the mask's
    device), and the logits they were drawn from (0 where legal, -1e9
    elsewhere); per head of a dict of masks."""
    logits = tree_map(lambda m: torch.where(m, 0.0, -1e9), mask)
    actions, _ = action_dist.sample(generator, logits)
    return actions, logits


class _EnvOps(NamedTuple):
    """The env-specific slice of the replay loop (flat or
    hierarchical), bound to one trace batch."""
    reset: Any          # () -> (state, ts)
    step: Any           # (state, action) -> (state', ts)
    capacity: int
    busy: Any           # state -> i32[E] allocated GPUs
    jct_stats: Any      # (state, traces) -> {avg_jct, max_jct, n_done}
    makespan: Any       # state -> f32[E]


def _env_ops(params, traces: core.Trace, faults=None) -> _EnvOps:
    if isinstance(params, HierParams):
        if faults is not None:
            raise ValueError("fault replay applies to flat configs (the "
                             "hierarchical env has no fault-process "
                             "support)")
        # the pod-repeated trace depends on the batch alone: built once
        ptrace = hier_lib.pod_traces(traces, params.n_pods)
        return _EnvOps(
            reset=lambda: hier_lib.reset(params, traces, ptrace),
            step=lambda s, a: hier_lib.step(params, s, traces, a, ptrace),
            capacity=params.n_pods * params.pod_capacity,
            busy=lambda s: s.pods.alloc.sum((1, 2, 3), dtype=torch.int32),
            jct_stats=hier_lib.jct_stats,
            makespan=lambda s: s.pods.clock[:, 0])
    return _EnvOps(
        reset=lambda: env_lib.reset(params, traces, faults),
        step=lambda s, a: env_lib.step(params, s, traces, a, faults),
        capacity=params.sim.capacity,
        busy=lambda s: s.sim.alloc.sum((1, 2), dtype=torch.int32),
        jct_stats=lambda s, tr: core.jct_stats(s.sim, tr),
        makespan=lambda s: s.sim.clock)


def check_modes(env_params, *, full_trace: bool = False,
                fairness: bool = False, percentiles=None) -> None:
    """Refuse, in JAX's words, the evaluation modes the hierarchical env
    lacks: the full-trace stitched replay, the fairness table and the
    percentile columns. A no-op on a flat env; the CLI calls it before
    it builds anything."""
    if not isinstance(env_params, HierParams):
        return
    if full_trace:
        raise ValueError("full-trace evaluation supports flat configs; "
                         "hierarchical pods replay per-window (jct_report)")
    if fairness:
        raise ValueError("fairness_report supports flat configs (tenant "
                         "ids live in the flat sim's trace)")
    if percentiles is not None:
        raise ValueError("percentiles are supported for flat configs")


def _fifo_preferences(env_params: EnvParams,
                      device: torch.device) -> torch.Tensor:
    """``f32[A]`` preference of the FIFO fall-through: the oldest queue
    slot first (pack before spread within a slot), then the no-op; the
    preempt slots below every valid choice, so FIFO never evicts."""
    sim = env_params.sim
    K, P, R = sim.queue_len, sim.n_placements, sim.preempt_len
    # built on the device: a host-to-device copy would wait for the card
    return torch.cat([
        torch.arange(K * P, 0, -1, dtype=torch.float32, device=device),
        torch.full((R,), -1.0, device=device),
        torch.full((1,), 0.5, device=device),
    ])


def _gate_to_fifo(prefs: torch.Tensor, sim_status: torch.Tensor,
                  mask: torch.Tensor, actions: torch.Tensor,
                  gate: int) -> torch.Tensor:
    """The backlog-gated hybrid: where fewer than ``gate`` jobs are
    PENDING, play FIFO-with-backfill instead of ``actions``: place the
    oldest pending job whose gang fits (the queue is submit-sorted), the
    oldest-first admit rule of the oracle baselines; no-op only when
    nothing fits; never preempt. ``prefs`` is
    :func:`_fifo_preferences`."""
    pending = torch.sum(sim_status == PENDING, dim=-1)
    fifo = torch.argmax(torch.where(mask, prefs, -torch.inf),
                        dim=-1).to(actions.dtype)
    return torch.where(pending < gate, fifo, actions)


def replay(net: "nn.Module | None", env_params: EnvParams,
           traces: core.Trace, max_steps: int | None = None,
           record: bool = False, policy: str = "greedy",
           generator: torch.Generator | None = None,
           return_states: bool = False, backlog_gate: int = 0,
           stall_guard: bool = True, faults=None):
    """Replay the batched trace windows under the policy ``net`` on the
    traces' device. Each cluster runs its window to completion (or
    ``max_steps``, default the horizon) and is then frozen while the
    others go on; there is no auto-reset.

    ``policy``: ``"greedy"`` (argmax over the masked logits, the
    deterministic replay) or ``"random"`` (masked-uniform, drawn from
    ``generator``, default one seeded 0 on the traces' device; ``net``
    is not called). ``backlog_gate > 0`` replays the backlog-gated
    hybrid (:func:`_gate_to_fifo`) of the greedy policy.

    ``stall_guard`` (preemptive action spaces, greedy replay only)
    breaks the place<->preempt argmax cycle, which costs no simulated
    time and so never ends: each cluster counts its consecutive zero-dt
    steps, and past :func:`..decision.stall_threshold` its preempt
    actions are masked until the clock moves (or the cluster is done).
    With preempts held a zero-dt run is finite; below the threshold the
    replay is the unguarded one. The count lives on the device and adds
    no host sync.

    ``faults`` (flat configs): the batched fault or domain schedules
    replayed next to the traces. A faulty cluster's episode may end
    short of completion (a node drained for good can strand work);
    completion is part of the reported degradation.

    A hierarchical ``env_params`` (config 5) replays its dict actions
    the same way; it has no backlog gate, no stall guard (its pods cannot
    preempt), no ``record`` and no ``faults``.

    Returns the :class:`EvalResult`, followed by the final ``EnvState``
    with ``return_states`` and the per-step :class:`ReplayRecord` with
    ``record``."""
    if policy not in ("greedy", "random"):
        raise ValueError(f"unknown replay policy {policy!r}; "
                         f"expected 'greedy' or 'random'")
    if backlog_gate < 0:
        raise ValueError("backlog_gate must be >= 0 (a negative gate never "
                         "engages: silently ungated)")
    if backlog_gate and policy == "random":
        raise ValueError("backlog_gate composes with the learned policy "
                         "only: gating the random control would overwrite "
                         "its actions with FIFO whenever the backlog is "
                         "shallow, silently inflating the baseline")
    is_hier = isinstance(env_params, HierParams)
    if backlog_gate and is_hier:
        raise ValueError("backlog_gate applies to flat configs (the "
                         "hierarchical action space has no single FIFO "
                         "fall-through action)")
    if record and is_hier:
        raise ValueError("record= applies to flat configs (the margin "
                         "rule reads one head's logits)")
    max_steps = int(max_steps or env_params.horizon)
    ops = _env_ops(env_params, traces, faults)
    capacity = ops.capacity
    dev = traces.submit.device
    if policy == "random" and generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    prefs = _fifo_preferences(env_params, dev) if backlog_gate else None
    pre = (preempt_slice(env_params, dev)
           if stall_guard and policy == "greedy" else None)
    thresh = stall_threshold(env_params) if pre is not None else 0
    acts, margins, gated = [], [], []
    with torch.inference_mode():
        state, ts = ops.reset()
        obs, mask = ts.obs, ts.action_mask
        done = torch.zeros_like(ts.done)
        busy_time = torch.zeros_like(ts.reward)
        stall = torch.zeros_like(done, dtype=torch.int32)
        for i in range(max_steps):
            if pre is not None:
                ungated = mask
                mask = gate_stalled(mask, stall, thresh, pre)
                if record:
                    gated.append((ungated != mask).any(-1))
            if policy == "random":
                actions, logits = _random_actions(generator, mask)
            else:
                logits, _ = net(obs, mask)
                actions = greedy_actions(logits)
            if prefs is not None:
                actions = _gate_to_fifo(prefs, state.sim.status, mask,
                                        actions, backlog_gate)
            if record:
                top2 = torch.topk(logits, 2, dim=-1).values
                acts.append(actions)
                margins.append(top2[:, 0] - top2[:, 1])
            new_state, new_ts = ops.step(state, actions)
            dt = torch.where(done, 0.0, new_ts.info.dt)
            busy_time = busy_time + ops.busy(state).to(torch.float32) * dt
            if pre is not None:
                stall = torch.where(done | (new_ts.info.dt > 0.0), 0,
                                    stall + 1)
            # freeze finished clusters: keep their old state, obs, mask
            state = core.select(done, state, new_state)
            obs = core.select(done, obs, new_ts.obs)
            mask = core.select(done, mask, new_ts.action_mask)
            done = done | new_ts.done
            if (i + 1) % _DONE_CHECK_EVERY == 0:
                with intended_sync():
                    finished = bool(done.all())
                if finished:
                    break
        stats = ops.jct_stats(state, traces)
        makespan = ops.makespan(state)
        util = busy_time / (torch.clamp_min(makespan, 1e-6) * capacity)
        result = EvalResult(avg_jct=stats["avg_jct"],
                            n_done=stats["n_done"],
                            n_valid=traces.valid.sum(1, dtype=torch.int32),
                            makespan=makespan, utilization=util,
                            steps=state.t)
    out: tuple = (result,)
    if return_states:
        out += (state,)
    if record:
        actions = torch.stack(acts)
        out += (ReplayRecord(actions, torch.stack(margins),
                             torch.stack(gated) if gated else
                             torch.zeros_like(actions, dtype=torch.bool)),)
    return out if len(out) > 1 else result


def _stitch_window(net: "nn.Module | None", rp: EnvParams,
                   trace: core.Trace, cutoff: torch.Tensor,
                   need_completion: bool, drain_block: int, n_steps: int,
                   policy: str, generator: torch.Generator | None,
                   prefs: torch.Tensor | None, backlog_gate: int,
                   pre: torch.Tensor | None, thresh: int,
                   schedule=None) -> core.SimState:
    """One window of :func:`full_trace_replay` (E=1): replay until the
    clock would pass ``cutoff`` (the step past it is discarded) or, with
    ``need_completion``, until ``drain_block`` valid jobs are done (the
    step that completes them is kept); then advance the clock over the
    continuous service up to the next event or the cutoff. Steps after
    the window froze change nothing, so the loop ends at the first
    64-step check that finds it frozen. ``schedule`` is the window's
    local-time fault or domain schedule (:func:`_shift_schedule`),
    batched ``[1, ...]``."""
    state, ts = env_lib.reset(rp, trace, schedule)
    obs, mask = ts.obs, ts.action_mask
    frozen = torch.zeros_like(ts.done)
    stall = torch.zeros_like(frozen, dtype=torch.int32)
    for i in range(n_steps):
        if pre is not None:
            mask = gate_stalled(mask, stall, thresh, pre)
        if policy == "random":
            action, _ = _random_actions(generator, mask)
        else:
            logits, _ = net(obs, mask)
            action = greedy_actions(logits)
        if prefs is not None:
            action = _gate_to_fifo(prefs, state.sim.status, mask, action,
                                   backlog_gate)
        new_state, new_ts = env_lib.step(rp, state, trace, action,
                                         schedule)
        if need_completion:
            done_before = torch.sum((state.sim.status == DONE)
                                    & trace.valid, dim=-1)
            past = (new_state.sim.clock > cutoff) & (done_before
                                                     >= drain_block)
        else:
            past = new_state.sim.clock > cutoff
        stop = frozen | past
        state = core.select(stop, state, new_state)
        obs = core.select(stop, obs, new_ts.obs)
        mask = core.select(stop, mask, new_ts.action_mask)
        frozen = stop | new_ts.done
        stall = torch.where(frozen | (new_ts.info.dt > 0.0), 0, stall + 1)
        if (i + 1) % _DONE_CHECK_EVERY == 0 and bool(frozen.all()):
            break
    # a future cutoff freezes the window at its last decision point not
    # beyond it; up to the cutoff there is no event (the next one
    # overshot), only service, which is advanced here, or running jobs
    # would lose (cutoff - clock) of work at every seam
    sim = state.sim
    t_end = torch.minimum(cutoff, core.next_event_time(sim, trace,
                                                       schedule))
    t_end = torch.maximum(t_end, sim.clock)
    return core.advance_to(sim, trace, t_end, schedule)


def _shift_schedule(fs, base: float):
    """Rebase one global-time host fault or domain schedule onto a
    stitched window's local clock (window time 0 = global ``base``): a
    drain wholly in the past never happens (+inf/+inf), one straddling
    ``base`` is active from local 0, later ones shift left. Slowdown and
    capacity do not depend on time and pass through; the result keeps
    the input's type."""
    start = np.asarray(fs.down_start, np.float64) - base
    end = np.asarray(fs.down_end, np.float64) - base
    past = end <= 0.0
    start = np.where(past, np.inf, np.maximum(start, 0.0))
    end = np.where(past, np.inf, end)
    return fs._replace(down_start=start.astype(np.float32),
                       down_end=end.astype(np.float32))


def full_trace_replay(net: "nn.Module | None", env_params: EnvParams,
                      source: ArrayTrace,
                      max_steps_per_window: int | None = None,
                      policy: str = "greedy",
                      generator: torch.Generator | None = None,
                      backlog_gate: int = 0, stall_guard: bool = True,
                      drain_completions: int = 1, faults=None,
                      device: "torch.device | str | None" = None,
                      ) -> dict[str, Any]:
    """The policy's avg JCT over an entire source trace by sequential
    windowed replay with residual carry: one number comparable to the
    baselines' over the same trace. ``device`` defaults to ``net``'s
    (``cuda`` for the random control without one).

    The trace streams through a fixed-shape job table of ``max_jobs``
    rows: each window holds the carried residual jobs (anything not done
    at the previous cutoff) and as many fresh jobs as fit, and replays
    under the policy only up to the arrival of the first excluded job
    (the cutoff), so a window never runs ahead of work it cannot see.
    When that job has already arrived (a deep backlog: global time has
    outrun the arrivals), the window instead runs until it completes
    ``drain_completions`` jobs (clamped to ``max_jobs // 2``), freeing
    rows, and global time advances by the sim time it used. JCT is
    accounted against the original submit times. Two approximations, as
    in JAX: a job running at a seam is carried as pending with its
    remaining service (a checkpointed preemption), and a future cutoff
    freezes the window at its last decision point not beyond it, the
    service up to the cutoff advanced without decisions.

    A window takes at most ``max_steps_per_window`` decision steps
    (default ``4 * max_jobs + 16``). ``policy``, ``backlog_gate`` and
    ``stall_guard`` are :func:`replay`'s; the random control draws from
    ``generator`` (default one seeded 0).

    ``faults``: one host fault or domain schedule (unbatched) in global
    trace time over the whole stream. Each window replays under it
    rebased onto its own clock (:func:`_shift_schedule`); baselines
    compared with this number run the same schedule unshifted on the
    oracle's one global clock. Returns ``{"avg_jct", "n_jobs", "jct",
    "finish", "tenant", "windows", "makespan", "drain_completions"}``,
    the last the value after the clamp."""
    check_modes(env_params, full_trace=True)
    if policy not in ("greedy", "random"):
        raise ValueError(f"unknown replay policy {policy!r}; "
                         f"expected 'greedy' or 'random'")
    if backlog_gate < 0:
        raise ValueError("backlog_gate must be >= 0 (a negative gate never "
                         "engages: silently ungated)")
    if backlog_gate and policy == "random":
        raise ValueError("backlog_gate composes with the learned policy "
                         "only: gating the random control would overwrite "
                         "its actions with FIFO whenever the backlog is "
                         "shallow, silently inflating the baseline")
    if drain_completions < 1:
        raise ValueError("drain_completions must be >= 1 (a deep-backlog "
                         "window must free at least one table row)")
    if device is None and net is not None:
        device = next(net.parameters()).device
    dev = resolve_device(device)
    if policy == "random" and generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    sim = env_params.sim
    if faults is not None and faults.down_start.shape[-2] != sim.n_nodes:
        raise ValueError(
            f"schedule covers {faults.down_start.shape[-2]} nodes; the "
            f"stitch cluster has {sim.n_nodes}")
    J = sim.max_jobs
    drain_block = min(int(drain_completions), max(J // 2, 1))
    S = int(max_steps_per_window or 4 * J + 16)
    # replay wants no horizon cut: only completion or the cutoff freeze
    rp = dataclasses.replace(env_params, horizon=S + 1)
    prefs = _fifo_preferences(env_params, dev) if backlog_gate else None
    pre = (preempt_slice(env_params, dev)
           if stall_guard and policy == "greedy" else None)
    thresh = stall_threshold(env_params) if pre is not None else 0

    valid = np.flatnonzero(np.asarray(source.valid))
    submit = np.asarray(source.submit, np.float64)[valid]
    duration = np.asarray(source.duration, np.float64)[valid]
    gpus = np.asarray(source.gpus, np.int32)[valid]
    tenant = np.asarray(source.tenant, np.int32)[valid]
    total = len(valid)
    if total == 0:
        raise ValueError("source trace has no valid jobs")
    # on a drawn geometry the bound is the drawn capacity: a gang wider
    # than the shrunken cluster would pend for ever
    cap = getattr(faults, "capacity", None)
    total_gpus = (int(np.asarray(cap).sum()) if cap is not None
                  else sim.capacity)
    if int(gpus.max()) > total_gpus:
        raise ValueError(
            f"source demands up to {int(gpus.max())} GPUs but the "
            f"{'drawn' if cap is not None else 'static'} cluster has "
            f"{total_gpus}; clamp the trace first "
            f"(sim.core.validate_trace(clamp=True)) or use a milder "
            f"domain draw")

    finish_g = np.full(total, np.nan)        # global finish times
    # residuals: original index -> remaining service
    res_idx = np.zeros(0, np.int64)
    res_rem = np.zeros(0, np.float64)
    base, cursor, n_windows = 0.0, 0, 0
    max_windows = 2 * total + 16   # >= 1 fresh job ingested per window
    with torch.inference_mode():
        while cursor < total or len(res_idx):
            n_windows += 1
            if n_windows > max_windows:
                raise RuntimeError(
                    f"full-trace replay made no progress after "
                    f"{n_windows} windows ({cursor}/{total} ingested, "
                    f"{len(res_idx)} residual)")
            n_fresh = min(J - len(res_idx), total - cursor)
            fresh = np.arange(cursor, cursor + n_fresh)
            rows_idx = np.concatenate([res_idx, fresh])
            rows_rem = np.concatenate([res_rem, duration[fresh]])
            # rows must be submit-sorted (the sim's queue order); a
            # carried not-yet-arrived residual can out-submit a fresh job
            order = np.lexsort((rows_idx,
                                np.maximum(submit[rows_idx] - base, 0.0)))
            rows_idx, rows_rem = rows_idx[order], rows_rem[order]
            n_rows = len(rows_idx)
            cutoff = (submit[cursor + n_fresh] - base
                      if cursor + n_fresh < total else np.inf)
            # deep backlog: the first excluded job has already arrived
            need_completion = bool(np.isfinite(cutoff) and cutoff <= 0.0)
            if need_completion:
                cutoff = 0.0

            w_submit = np.full(J, np.inf, np.float32)
            w_duration = np.ones(J, np.float32)
            w_gpus = np.zeros(J, np.int32)
            w_tenant = np.zeros(J, np.int32)
            w_valid = np.zeros(J, bool)
            w_submit[:n_rows] = np.maximum(submit[rows_idx] - base, 0.0)
            w_duration[:n_rows] = rows_rem
            w_gpus[:n_rows] = gpus[rows_idx]
            w_tenant[:n_rows] = tenant[rows_idx]
            w_valid[:n_rows] = True
            trace = core.Trace.from_array_traces(
                [ArrayTrace(w_submit, w_duration, w_gpus, w_tenant,
                            w_valid)], sim, dev)
            cut = torch.full((1,), np.float32(cutoff), device=dev)
            sched = (stack_fault_schedules([_shift_schedule(faults, base)],
                                           dev)
                     if faults is not None else None)
            s = _stitch_window(net, rp, trace, cut, need_completion,
                               drain_block, S, policy, generator, prefs,
                               backlog_gate, pre, thresh, sched)
            status = s.status[0, :n_rows].cpu().numpy()
            finish = s.finish[0, :n_rows].cpu().numpy()
            remaining = s.remaining[0, :n_rows].cpu().numpy()
            clock = float(s.clock[0])
            done_rows = status == DONE
            finish_g[rows_idx[done_rows]] = base + finish[done_rows]
            left = ~done_rows
            res_idx = rows_idx[left]
            res_rem = remaining.astype(np.float64)[left]
            # future cutoff: global time jumps to the excluded arrival;
            # completion mode and the final drain: by the sim time used
            base = base + (cutoff if np.isfinite(cutoff)
                           and not need_completion else clock)
            cursor += n_fresh

    jct = finish_g - submit
    assert np.isfinite(jct).all()
    return {"avg_jct": float(jct.mean()), "n_jobs": total,
            "jct": jct, "finish": finish_g, "tenant": tenant,
            "windows": n_windows, "makespan": float(np.nanmax(finish_g)),
            "drain_completions": drain_block}


def pooled_avg_jct(result: EvalResult) -> tuple[float, float]:
    """Completion-weighted mean JCT across clusters + completed fraction."""
    n = result.n_done.cpu().numpy().astype(np.float64)
    jct = result.avg_jct.cpu().numpy().astype(np.float64)
    total = n.sum()
    frac = float(total / max(int(result.n_valid.sum()), 1))
    return float((jct * n).sum() / max(total, 1.0)), frac


def _pct_row(jcts: np.ndarray,
             percentiles: tuple[float, ...]) -> dict[str, float]:
    """One scheduler's tail-latency columns, e.g. {"p50": .., "p99": ..}."""
    return {f"p{g:g}": float(np.percentile(jcts, g))
            for g in percentiles} if jcts.size else {}


def baseline_jcts(windows: list[ArrayTrace], n_nodes: int,
                  gpus_per_node: int, name: str,
                  backend: str = "auto") -> np.ndarray:
    """Pooled per-job JCTs of one baseline over the windows (completed
    valid jobs only), the array behind both the mean and the percentile
    columns."""
    jcts = [run_baseline(w, n_nodes, gpus_per_node, name, backend).jcts()
            for w in windows]
    return np.concatenate(jcts) if jcts else np.zeros(0)


def baseline_jct_table(windows: list[ArrayTrace], n_nodes: int,
                       gpus_per_node: int,
                       names: tuple[str, ...] = BASELINE_NAMES,
                       ) -> dict[str, float]:
    """Completion-weighted avg JCT per baseline over the same windows the
    policy is evaluated on."""
    return {name: float(np.mean(jcts)) if (jcts := baseline_jcts(
                windows, n_nodes, gpus_per_node, name)).size else 0.0
            for name in names}


def _replay_jcts(states, traces: core.Trace) -> np.ndarray:
    """Pooled per-job JCTs (completed valid jobs) from replay end states,
    in f64."""
    finish = states.sim.finish.cpu().numpy().astype(np.float64)
    submit = traces.submit.cpu().numpy().astype(np.float64)
    done = traces.valid.cpu().numpy() & np.isfinite(finish)
    return finish[done] - submit[done]


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def jct_report(exp, windows: list[ArrayTrace] | None = None,
               max_steps: int | None = None,
               baselines: tuple[str, ...] = BASELINE_NAMES,
               include_random: bool = True,
               percentiles: tuple[float, ...] | None = None,
               backlog_gate: int = 0, backend: str = "auto",
               stall_guard: bool = True) -> dict[str, Any]:
    """The comparison table for an assembled :class:`..experiment
    .Experiment`: the policy's greedy replay (on the experiment's
    device) against the baselines (on the host) on identical windows
    (default: the experiment's own).

    Returns ``{"policy": jct, "random": jct, <baseline>: jct, ...,
    "policy_completion": frac, "policy_utilization": u, "vs_tiresias":
    ratio}``; a ratio below 1 means the policy beats Tiresias. With
    ``percentiles`` (e.g. ``(50, 90, 99)``) the report also carries
    ``report["percentiles"][<row>]["p90"]``; a replay that did not
    complete every job gets an empty row, since cutting it short drops
    exactly the longest jobs and would flatter its tail. The report also
    records ``baseline_backend`` (``native`` or ``python``),
    ``policy_steps`` (decision steps, summed over windows) and
    ``wall_s``, the wall time of each part with the device synchronized
    around it (not counting a first-use build of the native engine).
    Wherever the stall guard can engage (a preemptive action space) the
    report records ``stall_guard``: guarded and unguarded rows come from
    different schedulers. On a hierarchical experiment the policy
    schedules gangs within pods while the baselines use the whole flat
    cluster: they get more placement freedom, so the comparison is
    conservative for the policy; ``percentiles`` is refused there."""
    dev = exp.device
    check_modes(exp.env_params, percentiles=percentiles)
    if windows is None:
        windows, traces = exp.windows, exp.traces
    else:
        traces = stack_traces(windows, exp.env_params, dev)
    report: dict[str, Any] = {}
    pcts: dict[str, dict[str, float]] = {}
    wall: dict[str, float] = {}
    if backlog_gate:
        report["backlog_gate"] = int(backlog_gate)
    if preempt_slice(exp.env_params) is not None:
        report["stall_guard"] = bool(stall_guard)
    t0 = _clock(dev)
    # the gate is part of the scheduler under evaluation (policy + FIFO
    # hybrid); the random control row stays pure random
    res, states = replay(exp.net, exp.env_params, traces, max_steps,
                         return_states=True, backlog_gate=backlog_gate,
                         stall_guard=stall_guard)
    report["policy"], report["policy_completion"] = pooled_avg_jct(res)
    report["policy_utilization"] = float(np.mean(res.utilization.cpu()
                                                 .numpy()))
    report["policy_steps"] = int(res.steps.sum())
    if percentiles is not None:
        pcts["policy"] = (_pct_row(_replay_jcts(states, traces), percentiles)
                          if report["policy_completion"] >= 1.0 else {})
    wall["policy_replay"] = _clock(dev) - t0
    if include_random:
        t0 = _clock(dev)
        rnd, rnd_states = replay(
            None, exp.env_params, traces, max_steps, policy="random",
            generator=torch.Generator(dev).manual_seed(RANDOM_SEED),
            return_states=True)
        report["random"], rnd_completion = pooled_avg_jct(rnd)
        if percentiles is not None:
            pcts["random"] = (_pct_row(_replay_jcts(rnd_states, traces),
                                       percentiles)
                              if rnd_completion >= 1.0 else {})
        wall["random_replay"] = _clock(dev) - t0
    if baselines:
        # resolving the backend builds the native engine on first use;
        # that one-off compile is not part of the baselines' time
        report["baseline_backend"] = resolve_backend(backend)
        t0 = time.perf_counter()
        for name in baselines:
            jcts = baseline_jcts(windows, exp.cfg.n_nodes,
                                 exp.cfg.gpus_per_node, name,
                                 report["baseline_backend"])
            report[name] = float(np.mean(jcts)) if jcts.size else 0.0
            if percentiles is not None:
                pcts[name] = _pct_row(jcts, percentiles)
        wall["baselines"] = time.perf_counter() - t0
    if "tiresias" in report and report["tiresias"] > 0:
        report["vs_tiresias"] = report["policy"] / report["tiresias"]
    if percentiles is not None:
        report["percentiles"] = pcts
    report["wall_s"] = wall
    return report


def full_trace_report(exp, max_jobs: int | None = None,
                      baselines: tuple[str, ...] = BASELINE_NAMES,
                      max_steps_per_window: int | None = None,
                      include_random: bool = True,
                      percentiles: tuple[float, ...] | None = None,
                      env_params: EnvParams | None = None,
                      backlog_gate: int = 0, stall_guard: bool = True,
                      drain_completions: int = 1,
                      faults=None) -> dict[str, Any]:
    """The full-trace comparison table (``evaluate --full-trace``): the
    policy's avg JCT by :func:`full_trace_replay` (on the experiment's
    device) against the baselines run over the same source trace (on
    the host, the native engine unless no compiler is present), the
    source cut to its first ``max_jobs`` jobs. ``include_random`` adds
    the masked-uniform control through the same stitched replay.

    ``env_params`` may deepen the stitch window (``sim.max_jobs``) and
    change the horizon, nothing else: the policy's observation and
    action spaces do not depend on the job table's size, everything
    else is baked into them. Besides JAX's keys the report records
    ``baseline_backend`` and ``wall_s``, the wall time of each part with
    the device synchronized around it.

    ``faults``: one global-time host fault or domain schedule the whole
    table runs under (``evaluate --full-trace --stitch-faults/
    --stitch-domain``): the policy rows stitch through it window by
    window, the baselines run it unshifted on the Python oracle (the
    native engine has no fault model), and the report is marked
    ``faulty_cluster``."""
    check_modes(exp.env_params, full_trace=True)
    check_modes(env_params, full_trace=True)
    eval_params = env_params or exp.env_params
    if env_params is not None:
        normalized = dataclasses.replace(
            eval_params, sim=dataclasses.replace(
                eval_params.sim, max_jobs=exp.env_params.sim.max_jobs),
            horizon=exp.env_params.horizon)
        if normalized != exp.env_params:
            raise ValueError(
                "env_params may change the stitch window (sim.max_jobs) "
                "and horizon only; every other field is baked into the "
                "checkpointed policy's observation and action spaces")
    dev = exp.device
    source = exp.source
    if max_jobs is not None and source.num_jobs > max_jobs:
        source = source.slice(0, max_jobs)
    pcts: dict[str, dict[str, float]] = {}
    wall: dict[str, float] = {}
    t0 = _clock(dev)
    out = full_trace_replay(exp.net, eval_params, source,
                            max_steps_per_window=max_steps_per_window,
                            backlog_gate=backlog_gate,
                            stall_guard=stall_guard,
                            drain_completions=drain_completions,
                            faults=faults, device=dev)
    wall["policy_replay"] = _clock(dev) - t0
    report: dict[str, Any] = {"policy": out["avg_jct"],
                              "n_jobs": out["n_jobs"],
                              "policy_windows": out["windows"]}
    if faults is not None:
        # a degraded-cluster table must never pass for a clean one
        report["faulty_cluster"] = True
    if backlog_gate:
        report["backlog_gate"] = int(backlog_gate)
    if eval_params.sim.preempt_len:
        report["stall_guard"] = bool(stall_guard)
    if out["drain_completions"] != 1:
        # the effective (clamped) batching: part of the evaluated
        # scheduler's approximation, so artifacts stay distinguishable
        report["drain_completions"] = int(out["drain_completions"])
    if percentiles is not None:
        # full_trace_replay finishes every job: no truncation bias here
        pcts["policy"] = _pct_row(out["jct"], percentiles)
    if include_random:
        t0 = _clock(dev)
        rnd = full_trace_replay(
            None, eval_params, source,
            max_steps_per_window=max_steps_per_window, policy="random",
            generator=torch.Generator(dev).manual_seed(RANDOM_SEED),
            drain_completions=drain_completions, faults=faults, device=dev)
        wall["random_replay"] = _clock(dev) - t0
        report["random"] = rnd["avg_jct"]
        if percentiles is not None:
            pcts["random"] = _pct_row(rnd["jct"], percentiles)
    if baselines:
        report["baseline_backend"] = ("python" if faults is not None
                                      else resolve_backend("auto"))
        t0 = time.perf_counter()
        for name in baselines:
            sim = run_baseline(source, exp.cfg.n_nodes,
                               exp.cfg.gpus_per_node, name,
                               report["baseline_backend"], faults=faults)
            report[name] = sim.avg_jct()
            if percentiles is not None:
                pcts[name] = _pct_row(sim.jcts(), percentiles)
        wall["baselines"] = time.perf_counter() - t0
    if report.get("tiresias"):
        report["vs_tiresias"] = report["policy"] / report["tiresias"]
    if percentiles is not None:
        report["percentiles"] = pcts
    report["wall_s"] = wall
    return report


# ---- the chaos and generalization matrices ---------------------------------

# the regime axis of evaluate --chaos: a clean control, uncorrelated
# drains, correlated drain storms, stragglers
CHAOS_REGIMES = ("none", "sporadic", "storm", "straggler")
# the eval axis of evaluate --matrix: the fixed-cluster control, load and
# duration jitter, heterogeneous hardware, sustained 1.6x overload
MATRIX_REGIMES = ("none", "baseline", "hetero", "overload")


def _chaos_conservation(states, traces: core.Trace, env_params: EnvParams,
                        faults=None) -> dict:
    """The no-job-lost contract over a batch of final replay states:
    every node's ``free + allocated`` is its capacity (a domain
    schedule's drawn capacity, else ``gpus_per_node``), a RUNNING job
    holds exactly its gang and any other job nothing, and every valid
    job has a lifecycle status: a drain kills jobs back to the queue,
    never leaks them or their GPUs. Returns ``{"jobs_lost",
    "conserved"}``."""
    alloc = states.sim.alloc.cpu().numpy()
    free = states.sim.free.cpu().numpy()
    status = states.sim.status.cpu().numpy()
    gpus = traces.gpus.cpu().numpy()
    valid = traces.valid.cpu().numpy()
    cap = getattr(faults, "capacity", None)
    expected = (env_params.sim.gpus_per_node if cap is None
                else cap.cpu().numpy())                  # scalar or [E, N]
    node_ok = bool((alloc.sum(axis=1) + free == expected).all())
    alloc_j = alloc.sum(axis=2)                          # [E, J]
    running = status == RUNNING
    run_ok = bool((alloc_j[running] == gpus[running]).all())
    idle_ok = bool((alloc_j[~running] == 0).all())
    live = np.isin(status, (NOT_ARRIVED, PENDING, RUNNING, DONE))
    lost = int(valid.sum() - (valid & live).sum())
    return {"jobs_lost": lost,
            "conserved": node_ok and run_ok and idle_ok and lost == 0}


def _oracle_rows(windows, schedules, n_nodes: int, gpus_per_node: int,
                 baselines) -> dict:
    """Each baseline's pooled avg JCT and completion over ``windows``,
    window ``i`` on the Python oracle under host schedule ``i``."""
    rows = {}
    for name in baselines:
        jcts, n_valid = [], 0
        for w, fs in zip(windows, schedules):
            jcts.append(run_baseline(w, n_nodes, gpus_per_node, name,
                                     faults=fs).jcts())
            n_valid += w.num_jobs
        pooled = np.concatenate(jcts) if jcts else np.zeros(0)
        rows[name] = {
            "avg_jct": float(pooled.mean()) if pooled.size else 0.0,
            "completion": float(pooled.size / max(n_valid, 1))}
    return rows


def _degradation(table: dict, bus, registry, seed: int, kind: str,
                 stats: dict) -> None:
    """Fill every cell's ``degradation`` (its avg JCT over the clean
    control's, per scheduler), then emit one ``kind`` event per cell and
    ``<stem>_<regime>_<scheduler>_*`` gauges."""
    clean = table["none"]
    for rows in table.values():
        for sched, row in rows.items():
            base = clean[sched]["avg_jct"]
            row["degradation"] = (row["avg_jct"] / base
                                  if base and np.isfinite(base) else None)
    event, stem, seed_key, prefix = {
        "chaos": ("env_fault", "chaos", "chaos_seed", "fault"),
        "matrix": ("domain_cell", "matrix", "matrix_seed", "domain")}[kind]
    for name, rows in table.items():
        for sched, row in rows.items():
            deg = row["degradation"]
            if bus is not None:
                bus.emit(event, regime=name, scheduler=sched,
                         avg_jct=round(row["avg_jct"], 3),
                         completion=round(row["completion"], 4),
                         degradation=(round(deg, 4) if deg is not None
                                      else None),
                         **{seed_key: int(seed)},
                         **{f"{prefix}_{k}": v
                            for k, v in stats[name].items()})
            if registry is not None:
                g = f"{stem}_{name}_{sched}"
                registry.gauge(f"{g}_avg_jct").set(row["avg_jct"])
                registry.gauge(f"{g}_completion").set(row["completion"])
                if deg is not None:
                    registry.gauge(f"{g}_degradation").set(deg)


def chaos_report(exp, regimes: tuple[str, ...] = CHAOS_REGIMES,
                 baselines: tuple[str, ...] = ("sjf", "tiresias"),
                 max_steps: int | None = None, seed: int = 0,
                 bus=None, registry=None, tracer=None) -> dict[str, Any]:
    """The fault regime x scheduler matrix (``evaluate --chaos``): the
    greedy policy (on the experiment's device) and the baselines (on the
    host oracle) replay the experiment's windows under the same seeded
    schedules, window ``e`` drawing ``(seed, e)``; one row per regime,
    each cell ``{"avg_jct", "completion", "degradation"}``, the last its
    JCT over the clean ``none`` row's (always evaluated, first). Every
    regime's policy replay must conserve jobs and GPUs
    (:func:`_chaos_conservation`), or this raises.

    ``bus`` gets one ``env_fault`` event per cell with the regime's
    schedule stats, ``registry`` the ``chaos_<regime>_<scheduler>_*``
    gauges, and ``tracer`` a ``chaos_regime`` span per row around its
    ``policy_replay`` and ``baseline`` spans."""
    from .obs.trace import NULL_TRACER
    from .sim.faults import (fault_horizon, resolve_regime,
                             sample_fault_schedule, schedule_stats)
    if tracer is None:
        tracer = NULL_TRACER
    if isinstance(exp.env_params, HierParams):
        raise ValueError("chaos evaluation supports flat configs (the "
                         "hierarchical env has no fault-process support)")
    env_params, dev = exp.env_params, exp.device
    windows, traces = exp.windows, exp.traces
    n_nodes, g = exp.cfg.n_nodes, exp.cfg.gpus_per_node
    horizon_s = fault_horizon(windows)
    regimes = list(dict.fromkeys(["none", *regimes]))
    report: dict[str, Any] = {
        "chaos_seed": int(seed), "fault_horizon_s": float(horizon_s),
        "chaos_regimes": list(regimes), "jobs_lost": 0,
        "regimes": {}, "fault_stats": {}}
    for name in regimes:
        with tracer.span("chaos_regime", regime=name):
            regime = resolve_regime(name)
            host = [sample_fault_schedule(n_nodes, regime, (seed, e),
                                          horizon_s)
                    for e in range(len(windows))]
            batched = stack_fault_schedules(host, dev)
            report["fault_stats"][name] = schedule_stats(batched)
            with tracer.span("policy_replay"):
                res, states = replay(exp.net, env_params, traces,
                                     max_steps, return_states=True,
                                     faults=batched)
            cons = _chaos_conservation(states, traces, env_params)
            if not cons["conserved"]:
                raise AssertionError(
                    f"conservation violated under regime {name!r}: "
                    f"{cons} — a fault schedule must delay jobs, never "
                    f"leak them or their GPUs")
            report["jobs_lost"] += cons["jobs_lost"]
            jct, completion = pooled_avg_jct(res)
            rows: dict[str, Any] = {
                "policy": {"avg_jct": jct, "completion": completion}}
            for bname in baselines:
                with tracer.span("baseline", scheduler=bname):
                    rows.update(_oracle_rows(windows, host, n_nodes, g,
                                             (bname,)))
            report["regimes"][name] = rows
    _degradation(report["regimes"], bus, registry, seed, "chaos",
                 report["fault_stats"])
    return report


def format_chaos(report: dict[str, Any]) -> str:
    """The chaos matrix as text: a row per regime, a column per
    scheduler, each cell ``avg JCT [completion] xdegradation``."""
    head = (f"chaos matrix (seed {report['chaos_seed']}, fault horizon "
            f"{report['fault_horizon_s']:.0f}s) — "
            f"avg JCT s [completion] ×degradation-vs-clean:")
    return _format_table(head, "regime", report["regimes"], [
        f"jobs lost across the matrix: {report['jobs_lost']} "
        f"(conservation contract: must be 0)"])


def _format_table(head: str, label: str, table: dict,
                  tail: list[str]) -> str:
    regimes = list(table)
    scheds = list(next(iter(table.values())))
    width = max(len(label), *(len(r) for r in regimes))
    cell_w = 24
    lines = [head, f"{label:<{width}}  " +
             "  ".join(f"{s:<{cell_w}}" for s in scheds)]
    for name in regimes:
        cells = []
        for s in scheds:
            row = table[name][s]
            deg = (f"×{row['degradation']:.2f}"
                   if row["degradation"] is not None else "×—")
            cells.append(f"{row['avg_jct']:>8.1f} "
                         f"[{row['completion']:>4.0%}] {deg:<7}")
        lines.append(f"{name:<{width}}  " +
                     "  ".join(f"{c:<{cell_w}}" for c in cells))
    return "\n".join(lines + tail)


def matrix_report(exp, regimes: tuple[str, ...] = MATRIX_REGIMES,
                  baselines: tuple[str, ...] = ("sjf", "tiresias"),
                  policies: "dict[str, tuple] | None" = None,
                  max_steps: int | None = None, seed: int = 0,
                  bus=None, registry=None, alarms=None) -> dict[str, Any]:
    """The train regime x eval regime generalization matrix
    (``evaluate --matrix``): one or more policies (greedy, on the
    experiment's device) and the baselines (host oracle) replay the
    same generated windows under the same seeded domain draws per eval
    regime: env ``e`` draws ``(seed, e)``, and its window is generated
    against that draw's actual capacity
    (:func:`..experiment.make_domain_windows` with the config's seed
    replaced by ``seed``). One column per eval regime (the fixed-cluster
    ``none`` control always first), one row per scheduler, each cell
    ``{"avg_jct", "completion", "degradation"}`` against ``none``.

    ``policies``: ``{row: (net, env_params)}``, default the experiment's
    own policy as ``policy``. Rows may differ in observation channels
    only; every row replays the same cluster draws. Every cell must
    conserve jobs and GPUs against the drawn capacity, or this raises.
    ``bus`` gets a ``domain_cell`` event per cell, ``registry`` the
    ``matrix_<regime>_<scheduler>_*`` gauges. ``alarms`` (an entered
    :class:`.obs.Alarms` scope) wraps each cell's replay in a dispatch:
    after the first cell, a program build or a host sync inside a
    replay is an alarm (the replay's 64-step done check is an intended
    read), and the first cell of each further row has amnesty, as in
    JAX."""
    from .domains import (domain_schedule, domain_stats, resolve_domain,
                          sample_env_domains, stack_domain_schedules,
                          validate_domain_schedule)
    from .experiment import make_domain_windows
    if isinstance(exp.env_params, HierParams):
        raise ValueError("the generalization matrix supports flat configs "
                         "(domain schedules carry per-node capacity "
                         "through the flat sim path only)")
    cfg, dev = exp.cfg, exp.device
    n_nodes, g = cfg.n_nodes, cfg.gpus_per_node
    if policies is None:
        policies = {"policy": (exp.net, exp.env_params)}
    for pname, (_, ep) in policies.items():
        if isinstance(ep, HierParams) or ep.sim != exp.env_params.sim:
            raise ValueError(
                f"matrix row {pname!r} has a different sim geometry than "
                f"the experiment; every row must replay the same cluster "
                f"draws (rows may differ in observation channels only)")
    regimes = list(dict.fromkeys(["none", *regimes]))
    # the matrix's draws and windows follow the matrix seed
    mcfg = dataclasses.replace(cfg, seed=int(seed))
    report: dict[str, Any] = {
        "matrix_seed": int(seed), "matrix_regimes": list(regimes),
        "jobs_lost": 0, "cells": {}, "domain_stats": {}}
    columns: dict[str, tuple] = {}       # built once, shared by every row
    for rname in regimes:
        draws = sample_env_domains(resolve_domain(rname), n_nodes, g,
                                   seed, cfg.n_envs)
        windows = make_domain_windows(mcfg, draws)
        host = [validate_domain_schedule(n_nodes, g, domain_schedule(d))
                for d in draws]
        columns[rname] = (windows, host,
                          stack_domain_schedules(host, dev),
                          stack_traces(windows, exp.env_params, dev))
        stats = [domain_stats(d) for d in draws]
        report["domain_stats"][rname] = {
            "mean_total_gpus": float(np.mean([s["total_gpus"]
                                              for s in stats])),
            "envs_with_nodes_off": int(sum(s["n_nodes_off"] > 0
                                           for s in stats)),
            "envs_hetero": int(sum(s["n_hetero"] > 0 for s in stats)),
            "max_slowdown": float(max(s["max_slowdown"] for s in stats)),
            "mean_load": float(np.mean([s["load"] for s in stats])),
        }
        report["cells"][rname] = {}
    dispatch = 0
    for pi, (pname, (net, ep)) in enumerate(policies.items()):
        for ci, rname in enumerate(regimes):
            _, _, batched, traces = columns[rname]
            if alarms is not None and ci == 0 and pi > 0:
                alarms.expect_recompile(
                    f"matrix row {pname!r}: first cell of a row with "
                    f"its own observation space")
            ctx = (alarms.dispatch(dispatch) if alarms is not None
                   else contextlib.nullcontext())
            with ctx:
                res, states = replay(net, ep, traces, max_steps,
                                     return_states=True, faults=batched)
            dispatch += 1
            cons = _chaos_conservation(states, traces, ep, faults=batched)
            if not cons["conserved"]:
                raise AssertionError(
                    f"conservation violated in matrix cell "
                    f"({pname!r}, {rname!r}): {cons} — a domain draw must "
                    f"shrink or slow the cluster, never leak jobs or "
                    f"GPUs")
            report["jobs_lost"] += cons["jobs_lost"]
            jct, completion = pooled_avg_jct(res)
            report["cells"][rname][pname] = {"avg_jct": jct,
                                             "completion": completion}
    for rname in regimes:
        windows, host, _, _ = columns[rname]
        report["cells"][rname].update(
            _oracle_rows(windows, host, n_nodes, g, baselines))
    _degradation(report["cells"], bus, registry, seed, "matrix",
                 report["domain_stats"])
    return report


def format_matrix(report: dict[str, Any]) -> str:
    """The generalization matrix as text: a row per eval regime, a
    column per scheduler, then each regime's draw summary."""
    head = (f"generalization matrix (seed {report['matrix_seed']}) — "
            f"avg JCT s [completion] ×degradation-vs-none:")
    tail = []
    for name, st in report["domain_stats"].items():
        tail.append(f"  {name}: ~{st['mean_total_gpus']:.1f} GPUs/env, "
                    f"{st['envs_with_nodes_off']} envs with nodes off, "
                    f"{st['envs_hetero']} hetero, "
                    f"max slowdown ×{st['max_slowdown']:.1f}, "
                    f"load {st['mean_load']:.2f}")
    tail.append(f"jobs lost across the matrix: {report['jobs_lost']} "
                f"(conservation contract: must be 0)")
    return _format_table(head, "eval regime", report["cells"], tail)


def jain_index(xs: np.ndarray) -> float:
    """Jain's fairness index over per-tenant values, ``(sum x)^2 / (n
    sum x^2)`` over the finite positive ones: 1.0 is perfectly even, 1/n
    all on one tenant; NaN when none is left."""
    xs = np.asarray(xs, np.float64)
    xs = xs[np.isfinite(xs) & (xs > 0)]
    if xs.size == 0:
        return float("nan")
    return float(xs.sum() ** 2 / (xs.size * np.square(xs).sum()))


def _pool_tenant_jct(finish: np.ndarray, submit: np.ndarray,
                     tenant: np.ndarray, done: np.ndarray,
                     n_tenants: int, sums: np.ndarray, counts: np.ndarray,
                     ) -> None:
    """Add the JCTs of the ``done`` jobs to their tenants' ``sums`` and
    ``counts`` (one bincount; padding rows are masked out before the
    subtraction)."""
    t = tenant[done]
    sums += np.bincount(t, weights=finish[done] - submit[done],
                        minlength=n_tenants)
    counts += np.bincount(t, minlength=n_tenants)


def _fair_row(sums: np.ndarray, counts: np.ndarray, n_valid: int) -> dict:
    per_tenant = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)
    return {
        # NaN, not 0.0, when nothing completed: a truncated replay must
        # not sort to the top of the table
        "avg_jct": (float(sums.sum() / counts.sum()) if counts.sum()
                    else float("nan")),
        "jain": jain_index(per_tenant),
        "completion": float(counts.sum() / max(n_valid, 1)),
        "tenant_avg_jct": [round(float(x), 1) for x in per_tenant]}


def fairness_report(exp, windows: list[ArrayTrace] | None = None,
                    max_steps: int | None = None,
                    baselines: tuple[str, ...] = BASELINE_NAMES,
                    backend: str = "auto") -> dict[str, Any]:
    """The multi-tenant fairness table of config 3: per-tenant avg JCT
    under the policy's greedy replay (on the experiment's device) and
    under each baseline (on the host), on identical windows (default:
    the experiment's own), with Jain's index over the per-tenant means
    beside each row's avg JCT and completion.

    Returns ``{"<name>": {"avg_jct", "jain", "completion",
    "tenant_avg_jct": [...]}, ...}`` with ``policy`` one of the rows.
    Tenants are pooled over every id present in the windows, not only
    ``cfg.n_tenants`` bins (a CSV maps each user to its own id)."""
    check_modes(exp.env_params, fairness=True)
    if windows is None:
        windows, traces = exp.windows, exp.traces
    else:
        traces = stack_traces(windows, exp.env_params, exp.device)
    n_tenants = max(int(exp.cfg.n_tenants), 1,
                    1 + max((int(np.asarray(w.tenant)[w.valid].max())
                             for w in windows if w.valid.any()),
                            default=0))
    n_valid = int(sum(w.num_jobs for w in windows))
    out: dict[str, Any] = {}
    _, states = replay(exp.net, exp.env_params, traces, max_steps,
                       return_states=True)
    finish = states.sim.finish.cpu().numpy()
    submit = traces.submit.cpu().numpy()
    tenant = traces.tenant.cpu().numpy()
    valid = traces.valid.cpu().numpy()
    sums = np.zeros(n_tenants)
    counts = np.zeros(n_tenants, np.int64)
    for e in range(finish.shape[0]):
        done = valid[e] & np.isfinite(finish[e])
        _pool_tenant_jct(finish[e], submit[e], tenant[e], done, n_tenants,
                         sums, counts)
    out["policy"] = _fair_row(sums, counts, n_valid)
    for name in baselines:
        sums = np.zeros(n_tenants)
        counts = np.zeros(n_tenants, np.int64)
        for w in windows:
            bl = run_baseline(w, exp.cfg.n_nodes, exp.cfg.gpus_per_node,
                              name, backend)
            bl_finish = np.asarray(bl.finish, np.float64)
            done = w.valid & np.isfinite(bl_finish)
            _pool_tenant_jct(bl_finish, np.asarray(w.submit, np.float64),
                             np.asarray(w.tenant), done, n_tenants, sums,
                             counts)
        out[name] = _fair_row(sums, counts, n_valid)
    return out


def format_fairness(report: dict[str, Any]) -> str:
    """The fairness table as text, rows by avg JCT (NaN last)."""
    width = max(len("scheduler"), *(len(k) for k in report))
    lines = [f"{'scheduler':<{width}}  avg JCT (s)  Jain(tenant JCT)  done",
             f"{'-' * width}  -----------  ----------------  ----"]
    order = sorted(report.items(),
                   key=lambda kv: (np.isnan(kv[1]["avg_jct"]),
                                   kv[1]["avg_jct"]))
    for k, v in order:
        lines.append(f"{k:<{width}}  {v['avg_jct']:>11.1f}  "
                     f"{v['jain']:>16.3f}  {v['completion']:>4.0%}")
    return "\n".join(lines)


def format_report(report: dict[str, Any]) -> str:
    """Human-readable JCT table (the BASELINE.md-style comparison)."""
    rows = [(k, v) for k, v in report.items()
            if isinstance(v, float) and k not in
            ("vs_tiresias", "policy_completion", "policy_utilization")]
    rows.sort(key=lambda kv: kv[1])
    width = max(len("scheduler"), *(len(k) for k, _ in rows))
    lines = [f"{'scheduler':<{width}}  avg JCT (s)",
             f"{'-' * width}  -----------"]
    for k, v in rows:
        lines.append(f"{k:<{width}}  {v:>11.1f}")
    if "percentiles" in report:
        cols = sorted({c for row in report["percentiles"].values()
                       for c in row},
                      key=lambda c: float(c[1:]))
        lines.append(f"{'':<{width}}  " +
                     "  ".join(f"{c:>9}" for c in cols))
        for k, _ in rows:
            row = report["percentiles"].get(k, {})
            lines.append(f"{k:<{width}}  " + "  ".join(
                f"{row[c]:>9.1f}" if c in row else f"{'—':>9}"
                for c in cols))
    if "vs_tiresias" in report:
        lines.append(f"policy/tiresias ratio: {report['vs_tiresias']:.3f} "
                     f"(<1 beats Tiresias)")
    if "policy_completion" in report:
        lines.append(f"policy completion: {report['policy_completion']:.1%}")
    if "baseline_backend" in report:
        lines.append(f"baselines on the {report['baseline_backend']} "
                     f"engine")
    return "\n".join(lines)
