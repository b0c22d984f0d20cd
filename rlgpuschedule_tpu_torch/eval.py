"""Trace replay and the JCT-vs-baselines table (L6) of the port.

Counterpart of ``EvalResult``, ``replay``, ``full_trace_replay``,
``pooled_avg_jct``, ``baseline_jcts``, ``baseline_jct_table``,
``jct_report``, ``full_trace_report``, ``format_report`` and the
fairness table (``jain_index``, ``fairness_report``,
``format_fairness``) in the JAX package's ``eval.py``. There the replay is
one ``lax.scan``; here it is a Python loop over decision steps whose
body stays on the device: no value comes back to the host inside the
loop, except one "all done?" check every 64 steps that ends the loop
early (a finished cluster is frozen, so the steps it skips would change
nothing).

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

Not here: fault replay (a stitched replay under a fault schedule
included) and the chaos and matrix reports; they come with their slices
(``ROADMAP.md`` queue 1).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from .algos import action_dist
from .algos.update import tree_map
from .decision import (gate_stalled, greedy_actions, preempt_slice,
                       stall_threshold)
from .device import resolve_device
from .env import env as env_lib
from .env import hier as hier_lib
from .env.env import EnvParams, stack_traces
from .env.hier import HierParams
from .sim import core
from .sim.core import DONE, PENDING
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


def _env_ops(params, traces: core.Trace) -> _EnvOps:
    if isinstance(params, HierParams):
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
        reset=lambda: env_lib.reset(params, traces),
        step=lambda s, a: env_lib.step(params, s, traces, a),
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
           stall_guard: bool = True):
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

    A hierarchical ``env_params`` (config 5) replays its dict actions
    the same way; it has no backlog gate, no stall guard (its pods cannot
    preempt) and no ``record``.

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
    ops = _env_ops(env_params, traces)
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
            if (i + 1) % _DONE_CHECK_EVERY == 0 and bool(done.all()):
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
                   pre: torch.Tensor | None, thresh: int) -> core.SimState:
    """One window of :func:`full_trace_replay` (E=1): replay until the
    clock would pass ``cutoff`` (the step past it is discarded) or, with
    ``need_completion``, until ``drain_block`` valid jobs are done (the
    step that completes them is kept); then advance the clock over the
    continuous service up to the next event or the cutoff. Steps after
    the window froze change nothing, so the loop ends at the first
    64-step check that finds it frozen."""
    state, ts = env_lib.reset(rp, trace)
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
        new_state, new_ts = env_lib.step(rp, state, trace, action)
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
    t_end = torch.minimum(cutoff, core.next_event_time(sim, trace))
    t_end = torch.maximum(t_end, sim.clock)
    return core.advance_to(sim, trace, t_end)


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
    ``generator`` (default one seeded 0). ``faults`` waits for the
    chaos slice. Returns ``{"avg_jct", "n_jobs", "jct", "finish",
    "tenant", "windows", "makespan", "drain_completions"}``, the last
    the value after the clamp."""
    check_modes(env_params, full_trace=True)
    if faults is not None:
        raise NotImplementedError(
            "a stitched replay under a fault schedule (faults=, "
            "evaluate --stitch-faults/--stitch-domain) waits for the "
            "chaos and domain slice (ROADMAP.md queue 1, item 17)")
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
    if int(gpus.max()) > sim.capacity:
        raise ValueError(
            f"source demands up to {int(gpus.max())} GPUs but the cluster "
            f"has {sim.capacity}; clamp the trace first "
            f"(sim.core.validate_trace(clamp=True))")

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
            s = _stitch_window(net, rp, trace, cut, need_completion,
                               drain_block, S, policy, generator, prefs,
                               backlog_gate, pre, thresh)
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
    the device synchronized around it."""
    if faults is not None:
        raise NotImplementedError(
            "a full-trace table under a fault schedule waits for the "
            "chaos and domain slice (ROADMAP.md queue 1, item 17)")
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
                            device=dev)
    wall["policy_replay"] = _clock(dev) - t0
    report: dict[str, Any] = {"policy": out["avg_jct"],
                              "n_jobs": out["n_jobs"],
                              "policy_windows": out["windows"]}
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
            drain_completions=drain_completions, device=dev)
        wall["random_replay"] = _clock(dev) - t0
        report["random"] = rnd["avg_jct"]
        if percentiles is not None:
            pcts["random"] = _pct_row(rnd["jct"], percentiles)
    if baselines:
        report["baseline_backend"] = resolve_backend("auto")
        t0 = time.perf_counter()
        for name in baselines:
            sim = run_baseline(source, exp.cfg.n_nodes,
                               exp.cfg.gpus_per_node, name,
                               report["baseline_backend"])
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
