"""Greedy trace replay (L6) of the port.

Counterpart of ``EvalResult``, ``replay`` and ``pooled_avg_jct`` in the
JAX package's ``eval.py``. There the replay is one ``lax.scan``; here it
is a Python loop over decision steps whose body stays on the device:
no value comes back to the host inside the loop, except one "all done?"
check every 64 steps that ends the loop early (a finished cluster is
frozen, so the steps it skips would change nothing).

Greedy play only: no fault schedules, no backlog gate, no random
policy; those wait for the slices that bring faults and training.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .decision import greedy_actions
from .env import env as env_lib
from .env.env import EnvParams
from .sim import core

_DONE_CHECK_EVERY = 64


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
    actions: torch.Tensor   # i64 greedy action
    margin: torch.Tensor    # f32 top-1 minus top-2 masked logit


def replay(policy: nn.Module, env_params: EnvParams, traces: core.Trace,
           max_steps: int | None = None, record: bool = False,
           ) -> "EvalResult | tuple[EvalResult, ReplayRecord]":
    """Replay the batched trace windows greedily under ``policy`` on the
    traces' device. Each cluster runs its window to completion (or
    ``max_steps``, default the horizon) and is then frozen while the
    others go on. With ``record``, also return the per-step
    :class:`ReplayRecord`."""
    max_steps = int(max_steps or env_params.horizon)
    capacity = env_params.sim.capacity
    acts, margins = [], []
    with torch.inference_mode():
        state, ts = env_lib.reset(env_params, traces)
        obs, mask = ts.obs, ts.action_mask
        done = torch.zeros_like(ts.done)
        busy_time = torch.zeros_like(ts.reward)
        for i in range(max_steps):
            logits, _ = policy(obs, mask)
            actions = greedy_actions(logits)
            if record:
                top2 = torch.topk(logits, 2, dim=-1).values
                acts.append(actions)
                margins.append(top2[:, 0] - top2[:, 1])
            new_state, new_ts = env_lib.step(env_params, state, traces,
                                             actions)
            dt = torch.where(done, 0.0, new_ts.info.dt)
            busy = state.sim.alloc.sum((1, 2), dtype=torch.int32)
            busy_time = busy_time + busy.to(torch.float32) * dt
            # freeze finished clusters: keep their old state, obs, mask
            state = core.select(done, state, new_state)
            obs = core.select(done, obs, new_ts.obs)
            mask = core.select(done, mask, new_ts.action_mask)
            done = done | new_ts.done
            if (i + 1) % _DONE_CHECK_EVERY == 0 and bool(done.all()):
                break
        stats = core.jct_stats(state.sim, traces)
        makespan = state.sim.clock
        util = busy_time / (torch.clamp_min(makespan, 1e-6) * capacity)
        result = EvalResult(avg_jct=stats["avg_jct"],
                            n_done=stats["n_done"],
                            n_valid=traces.valid.sum(1, dtype=torch.int32),
                            makespan=makespan, utilization=util,
                            steps=state.t)
    if record:
        return result, ReplayRecord(torch.stack(acts), torch.stack(margins))
    return result


def pooled_avg_jct(result: EvalResult) -> tuple[float, float]:
    """Completion-weighted mean JCT across clusters + completed fraction."""
    n = result.n_done.cpu().numpy().astype(np.float64)
    jct = result.avg_jct.cpu().numpy().astype(np.float64)
    total = n.sum()
    frac = float(total / max(int(result.n_valid.sum()), 1))
    return float((jct * n).sum() / max(total, 1.0)), frac
