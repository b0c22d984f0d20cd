"""Hierarchical multi-pod environment (L2) of the port: config 5's
workload.

Counterpart of the JAX package's ``env/hier.py``: a scheduler of
schedulers over ``n_pods`` simulated pods. A top-level router assigns
each arriving job to one pod; per-pod placement agents (shared weights,
one action per pod per step) schedule their own pod's queue. One joint
decision step:

1. the router action (``action["top"]``: pod index or no-op) routes the
   head arrived-but-unassigned job into that pod's queue;
2. every pod's action (``action["pods"][:, p]``: queue slot x placement
   or no-op) gang-places within its pod, all at the same virtual time;
3. only if nothing was routed or placed, time advances to the next
   global event (the earliest trace arrival or pod completion); with no
   event left, forced progress (route the head to the freest pod, else
   pack every pod's queue head) keeps the episode live.

A job lives in exactly one pod: every pod starts with every job inert
(``DONE``, the sim's "not mine") and routing flips the job to
``PENDING`` in the chosen pod only. Do not build pods with
``core.init_state``; ``core.advance_to`` promotes only ``NOT_ARRIVED``
rows, so inert rows stay inert. Global metrics reduce over the pod
axis: a job's finish is the minimum of its pods' finish times.

The batch: E envs of P pods. The pods of every env are one
:class:`..sim.core.SimState` ``[E, P, ...]``, flattened to ``E*P``
clusters for each call into :mod:`..sim.core` (each env's ``Trace``
rows repeated once per pod), so a step runs the batched simulator once
for all pods and has no loop over pods. Every outcome is computed and
then selected per env, as in ``core.rl_step``. Observations and masks
are dicts ``{"top": [E, ...], "pods": [E, P, ...]}``. On integer-valued
traces the state, observations, masks and rewards are bit-identical to
the jitted JAX env's (``tests/test_torch_hier.py``).
"""
from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple

import torch

from ..sim import core
from ..sim.core import (DONE, INF, PENDING, RUNNING, SimParams, SimState,
                        StepInfo, Trace, _take)
from ..traces.records import ArrayTrace
from . import env as env_lib
from . import obs as obs_lib
from . import rewards as reward_lib
from .env import TimeStep


@dataclasses.dataclass(frozen=True)
class HierParams:
    """Static hierarchical-env configuration. ``pod_sim`` describes ONE
    pod's geometry (nodes per pod x GPUs); the cluster is ``n_pods x
    pod_sim.n_nodes`` nodes."""
    n_pods: int
    pod_sim: SimParams
    time_scale: float = 600.0
    reward_scale: float = 10_000.0
    place_bonus: float = 0.0    # shaping per progress step (rewards.py)
    horizon: int = 512

    # top-level observation: per-pod summaries + head-job features + globals
    POD_SUMMARY_FEATURES = 3
    HEAD_FEATURES = 4

    @property
    def n_top_actions(self) -> int:
        return self.n_pods + 1          # route to pod p | no-op

    @property
    def pod_capacity(self) -> int:
        return self.pod_sim.capacity

    def top_obs_dim(self) -> int:
        return (self.n_pods * self.POD_SUMMARY_FEATURES
                + self.HEAD_FEATURES + 2)

    def obs_shape(self) -> dict:
        """Per-env observation shapes (no leading E)."""
        pod = self.pod_sim
        return {"top": (self.top_obs_dim(),),
                "pods": (self.n_pods, pod.n_nodes + 4 * pod.queue_len + 2)}


class HierState(NamedTuple):
    pods: SimState            # every leaf [E, P, ...]
    assignment: torch.Tensor  # i32[E, J]; -1 = not yet routed
    t: torch.Tensor           # i32[E] decision steps taken


def validate_hier_trace(params: HierParams, tr: ArrayTrace,
                        clamp: bool = False) -> ArrayTrace:
    """A job demanding more GPUs than ONE POD holds can never be placed
    (gangs do not span pods): :func:`..sim.core.validate_trace` at pod
    granularity."""
    return core.validate_trace(params.pod_sim, tr, clamp=clamp)


# ---- the pod batch ----------------------------------------------------------

def _flat(pods: SimState) -> SimState:
    """``[E, P, ...]`` pods as ``E*P`` clusters."""
    return SimState(*(x.reshape(-1, *x.shape[2:]) for x in pods))


def _unflat(pods: SimState, n_pods: int) -> SimState:
    return SimState(*(x.reshape(-1, n_pods, *x.shape[1:]) for x in pods))


def pod_traces(trace: Trace, n_pods: int) -> Trace:
    """Each env's trace rows once per pod: ``[E, J]`` -> ``[E*P, J]``,
    env-major like :func:`_flat`."""
    return Trace(*(x.repeat_interleave(n_pods, dim=0) for x in trace))


def pod_init(params: HierParams, trace: Trace) -> SimState:
    """Every env's pods ``[E, P, ...]`` with every job inert (``DONE``)
    until routed in."""
    E, J = trace.submit.shape
    P, N = params.n_pods, params.pod_sim.n_nodes
    dev = trace.submit.device
    return SimState(
        clock=torch.zeros(E, P, dtype=torch.float32, device=dev),
        status=torch.full((E, P, J), DONE, dtype=torch.int32, device=dev),
        remaining=trace.duration[:, None].expand(E, P, J).clone(),
        start=torch.full((E, P, J), INF, dtype=torch.float32, device=dev),
        finish=torch.full((E, P, J), INF, dtype=torch.float32, device=dev),
        alloc=torch.zeros(E, P, J, N, dtype=torch.int32, device=dev),
        free=torch.full((E, P, N), params.pod_sim.gpus_per_node,
                        dtype=torch.int32, device=dev),
    )


# ---- global queries ---------------------------------------------------------

def global_clock(state: HierState) -> torch.Tensor:
    return state.pods.clock[:, 0]           # pods advance in lockstep


def finished_mask(state: HierState, trace: Trace) -> torch.Tensor:
    """``bool[E, J]``: the job completed in whichever pod ran it."""
    return trace.valid & (state.pods.finish.amin(1) < INF)


def arrived_mask(state: HierState, trace: Trace,
                 clock: torch.Tensor | None = None) -> torch.Tensor:
    clock = global_clock(state) if clock is None else clock
    return trace.valid & (trace.submit <= clock[:, None])


def unassigned_mask(state: HierState, trace: Trace) -> torch.Tensor:
    return arrived_mask(state, trace) & (state.assignment < 0)


def _head(unassigned: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(first set row, any set) of ``bool[E, J]``, each ``[E]`` (argmax
    over an integer cast: torch's argmax does not take bool
    everywhere)."""
    return (torch.argmax(unassigned.to(torch.int32), dim=1).to(torch.int32),
            unassigned.any(1))


def head_unassigned(state: HierState, trace: Trace,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(row of the earliest-submitted arrived-unassigned job, exists),
    each ``[E]``. Trace rows are submit-sorted, so the first set row of
    the mask is the head."""
    return _head(unassigned_mask(state, trace))


def in_system(state: HierState, trace: Trace) -> torch.Tensor:
    """Arrived and not finished: jobs still waiting in the router count,
    so leaving work unrouted costs exactly what leaving it queued
    does."""
    return (arrived_mask(state, trace)
            & ~finished_mask(state, trace)).sum(1, dtype=torch.int32)


def all_done(state: HierState, trace: Trace) -> torch.Tensor:
    return torch.where(trace.valid, finished_mask(state, trace), True).all(1)


def jct_stats(state: HierState, trace: Trace) -> dict[str, torch.Tensor]:
    """Avg/max JCT over completed valid jobs, per env."""
    finish = state.pods.finish.amin(1)
    done = finished_mask(state, trace)
    jct = torch.where(done, finish - trace.submit, 0.0)
    n_done = done.sum(1, dtype=torch.int32)
    return {"avg_jct": jct.sum(1) / torch.clamp_min(n_done, 1),
            "max_jct": torch.where(done, jct, -INF).amax(1),
            "n_done": n_done}


# ---- state transforms -------------------------------------------------------

def apply_route(params: HierParams, state: HierState, pod: torch.Tensor,
                j: torch.Tensor, ok: torch.Tensor) -> HierState:
    """Route job row ``j[e]`` into pod ``pod[e]``'s queue (``PENDING``
    there) wherever ``ok[e]``; elsewhere nothing changes."""
    dev = j.device
    rows = torch.arange(params.pod_sim.max_jobs, device=dev)
    row = (rows[None, :] == j[:, None]) & ok[:, None]               # [E, J]
    pods = torch.arange(params.n_pods, device=dev)
    pod_row = (pods[None, :] == pod[:, None]) & ok[:, None]         # [E, P]
    hit = pod_row[:, :, None] & row[:, None, :]                     # [E, P, J]
    return HierState(
        pods=state.pods._replace(
            status=torch.where(hit, PENDING, state.pods.status)),
        assignment=torch.where(row, pod[:, None].to(torch.int32),
                               state.assignment),
        t=state.t)


def pod_place(params: HierParams, pods: SimState, ptrace: Trace,
              action: torch.Tensor) -> tuple[SimState, torch.Tensor]:
    """Every pod's placement action (queue slot x placement | no-op) on
    the flattened ``E*P`` pods: the action decode and ``try_place`` half
    of ``core.rl_step``, with no time advance (the hierarchy advances
    time globally)."""
    sp = params.pod_sim
    K, Pl = sp.queue_len, sp.n_placements
    queue = core.pending_queue(sp, pods)
    is_noop = action >= K * Pl
    if Pl == 1:
        k, mode = action.clamp(0, K - 1), None
    else:
        k, mode = (action // Pl).clamp(0, K - 1), action % Pl
    j = torch.where(is_noop, -1, _take(queue, k))
    return core.try_place(sp, pods, ptrace, j, mode)


def next_event_time(state: HierState, trace: Trace,
                    ptrace: Trace) -> torch.Tensor:
    """Earliest future trace arrival or any pod's completion per env
    (+inf if none)."""
    clock = global_clock(state)
    t_arr = torch.where(trace.valid & (trace.submit > clock[:, None]),
                        trace.submit, INF).amin(1)
    pod_next = core.next_event_time(_flat(state.pods), ptrace)
    return torch.minimum(t_arr, pod_next.reshape(-1, state.pods.clock.shape[1])
                         .amin(1))


def advance_all(state: HierState, ptrace: Trace,
                t: torch.Tensor) -> HierState:
    P = state.pods.clock.shape[1]
    pods = core.advance_to(_flat(state.pods), ptrace,
                           t.repeat_interleave(P))
    return state._replace(pods=_unflat(pods, P))


def forced_progress(params: HierParams, state: HierState, trace: Trace,
                    ptrace: Trace) -> tuple[HierState, torch.Tensor]:
    """Liveness fallback when the agents no-op with no event left: route
    the head unassigned job to the pod with the most free GPUs; with
    nothing to route, pack-place every pod's queue head (validation
    guarantees a head fits an empty pod). Both candidates are computed
    and picked per env."""
    j, exists = head_unassigned(state, trace)
    pod_free = state.pods.free.sum(2, dtype=torch.int32)           # [E, P]
    best = torch.argmax(pod_free, dim=1).to(torch.int32)
    routed = apply_route(params, state, best, j, exists)
    flat = _flat(state.pods)
    queue = core.pending_queue(params.pod_sim, flat)
    placed_pods, placed_ok = core.try_place(params.pod_sim, flat, ptrace,
                                            queue[:, 0], None)
    placed = state._replace(pods=_unflat(placed_pods, params.n_pods))
    return (core.select(exists, routed, placed),
            exists | placed_ok.reshape(-1, params.n_pods).any(1))


# ---- observations / masks ---------------------------------------------------

class _Shared(NamedTuple):
    """What the observation and the action mask both read of one state,
    computed once per step by :func:`_observe`."""
    queues: torch.Tensor      # i32[E*P, K] every pod's pending queue
    unassigned: torch.Tensor  # bool[E, J] arrived and not yet routed
    head: torch.Tensor        # i32[E] the first unassigned row
    exists: torch.Tensor      # bool[E] any unassigned row


def _share(params: HierParams, state: HierState, trace: Trace) -> _Shared:
    unassigned = unassigned_mask(state, trace)
    return _Shared(core.pending_queue(params.pod_sim, _flat(state.pods)),
                   unassigned, *_head(unassigned))


def build_obs(params: HierParams, state: HierState, trace: Trace,
              ptrace: Trace, shared: _Shared | None = None) -> dict:
    """``{"top": [E, 3P + 6], "pods": [E, P, N + 4K + 2]}``: each pod's
    flat observation, and the router's per-pod summaries (free
    fraction, pending / queue_len, running / capacity), the head job
    (exists, demand / capacity, tanh of its wait and of its duration)
    and the global load (unassigned and in-system counts / max_jobs).
    Divisions by a constant are products with its reciprocal, as in
    :mod:`.obs`."""
    sp = params.pod_sim
    E, P = state.pods.clock.shape
    clock = global_clock(state)
    sh = _share(params, state, trace) if shared is None else shared
    pod_obs = obs_lib.flat_obs(sp, _flat(state.pods), ptrace,
                               params.time_scale,
                               sh.queues).reshape(E, P, -1)
    pods = state.pods
    free_frac = (pods.free.sum(2, dtype=torch.int32).to(torch.float32)
                 * (1.0 / sp.capacity))
    pending = (pods.status == PENDING).sum(2, dtype=torch.int32)
    running = (pods.status == RUNNING).sum(2, dtype=torch.int32)
    summary = torch.stack([free_frac,
                           pending.to(torch.float32) * (1.0 / sp.queue_len),
                           running.to(torch.float32) * (1.0 / sp.capacity)],
                          dim=2)                                   # [E, P, 3]
    j, exists = sh.head, sh.exists
    e = exists.to(torch.float32)
    head = torch.stack([
        e,
        _take(trace.gpus, j).to(torch.float32) * (1.0 / sp.capacity) * e,
        obs_lib._tanh(torch.where(exists, clock - _take(trace.submit, j),
                                  0.0) * (1.0 / params.time_scale)),
        obs_lib._tanh(torch.where(exists, _take(trace.duration, j), 0.0)
                      * (1.0 / params.time_scale))], dim=1)        # [E, 4]
    n_unassigned = sh.unassigned.sum(1, dtype=torch.int32)
    globals_ = torch.stack(
        [n_unassigned.to(torch.float32) * (1.0 / sp.max_jobs),
         in_system(state, trace).to(torch.float32) * (1.0 / sp.max_jobs)],
        dim=1)
    top = torch.cat([summary.reshape(E, -1), head, globals_], dim=1)
    return {"top": top, "pods": pod_obs}


def action_mask(params: HierParams, state: HierState, trace: Trace,
                ptrace: Trace, shared: _Shared | None = None) -> dict:
    """``{"top": bool[E, P+1], "pods": bool[E, P, A]}``: routing is legal
    to every pod while an arrived unassigned head exists whose gang fits
    a pod; no-op always; each pod's mask is ``core.action_mask``."""
    E, P = state.pods.clock.shape
    sh = _share(params, state, trace) if shared is None else shared
    fits = _take(trace.gpus, sh.head) <= params.pod_capacity
    route_ok = (sh.exists & fits)[:, None].expand(E, P)
    top = torch.cat([route_ok, torch.ones(E, 1, dtype=torch.bool,
                                          device=route_ok.device)], dim=1)
    pod_masks = core.action_mask(params.pod_sim, _flat(state.pods), ptrace,
                                 sh.queues)
    return {"top": top, "pods": pod_masks.reshape(E, P, -1)}


def _observe(params: HierParams, state: HierState, trace: Trace,
             ptrace: Trace) -> tuple[dict, dict]:
    """(obs, mask), computing every pod's pending queue and the head job
    once and sharing them between the observation builder and the
    action mask."""
    shared = _share(params, state, trace)
    return (build_obs(params, state, trace, ptrace, shared),
            action_mask(params, state, trace, ptrace, shared))


# ---- reset / step -----------------------------------------------------------

def reset(params: HierParams, trace: Trace, ptrace: Trace | None = None,
          ) -> tuple[HierState, TimeStep]:
    """Every env at its start; ``ptrace`` is ``pod_traces(trace,
    params.n_pods)``, built here when not given."""
    E, J = trace.submit.shape
    dev = trace.submit.device
    state = HierState(
        pods=pod_init(params, trace),
        assignment=torch.full((E, J), -1, dtype=torch.int32, device=dev),
        t=torch.zeros(E, dtype=torch.int32, device=dev))
    false = torch.zeros(E, dtype=torch.bool, device=dev)
    zero = torch.zeros(E, dtype=torch.float32, device=dev)
    info = StepInfo(placed=false, dt=zero,
                    in_system_before=in_system(state, trace), done=false,
                    preempted=false, first_placed=false)
    if ptrace is None:
        ptrace = pod_traces(trace, params.n_pods)
    obs, mask = _observe(params, state, trace, ptrace)
    return state, TimeStep(obs=obs, reward=zero, done=false,
                           action_mask=mask, info=info)


def step(params: HierParams, state: HierState, trace: Trace,
         action: dict, ptrace: Trace | None = None,
         ) -> tuple[HierState, TimeStep]:
    """One joint decision step of every env (see the module docstring);
    ``action = {"top": i32[E], "pods": i32[E, P]}``. ``ptrace`` is
    ``pod_traces(trace, params.n_pods)``: a loop over one trace batch
    builds it once and passes it in; built here when not given."""
    P = params.n_pods
    if ptrace is None:
        ptrace = pod_traces(trace, P)
    clock = global_clock(state)
    n_before = in_system(state, trace)

    # 1. route (top head)
    top = action["top"]
    j, exists = head_unassigned(state, trace)
    is_route = top < P
    pod_choice = top.clamp(0, P - 1).to(torch.int32)
    fits = _take(trace.gpus, j) <= params.pod_capacity
    route_ok = is_route & exists & fits
    routed = apply_route(params, state, pod_choice, j, route_ok)

    # 2. pod placements (on the post-routing pods, same virtual time)
    pods2, placed = pod_place(params, _flat(routed.pods), ptrace,
                              action["pods"].reshape(-1))
    acted = routed._replace(pods=_unflat(pods2, P))
    progress = route_ok | placed.reshape(-1, P).any(1)
    # a failed route or placement leaves the state bit-identical, so the
    # advance and forced candidates below start from `acted` in every case

    # 3. advance time, or forced progress when no event is left
    t_next = next_event_time(acted, trace, ptrace)
    has_event = torch.isfinite(t_next)
    advanced = advance_all(acted, ptrace, t_next)
    forced, forced_ok = forced_progress(params, acted, trace, ptrace)
    new_state = core.select(progress, acted,
                            core.select(has_event, advanced, forced))
    new_state = new_state._replace(t=state.t + 1)
    dt = torch.where(progress | ~has_event, 0.0, t_next - clock)
    acted_ok = progress | (~progress & ~has_event & forced_ok)
    # no preemption in the hierarchy, so every progress step is "first"
    # (a job routes once and places once: the bonus stays bounded)
    info = StepInfo(placed=acted_ok, dt=dt, in_system_before=n_before,
                    done=all_done(new_state, trace),
                    preempted=torch.zeros_like(acted_ok),
                    first_placed=acted_ok)
    reward = reward_lib.reward_jct(info, params.reward_scale,
                                   params.place_bonus)
    done = info.done | (new_state.t >= params.horizon)
    obs, mask = _observe(params, new_state, trace, ptrace)
    return new_state, TimeStep(obs=obs, reward=reward, done=done,
                               action_mask=mask, info=info)


def _refuse_faults(faults) -> None:
    """JAX's refusal: the pods have no fault process."""
    if faults is not None:
        raise ValueError("the hierarchical env has no fault-process "
                         "support; cluster chaos (sim.faults) is a flat-"
                         "config feature for now")


def vec_reset(params: HierParams, traces: Trace, faults=None,
              ) -> tuple[HierState, TimeStep]:
    """:func:`reset` (batched over envs already); ``faults`` is refused,
    as JAX refuses it."""
    _refuse_faults(faults)
    return reset(params, traces)


def vec_step(params: HierParams, state: HierState, traces: Trace,
             actions: dict, fresh: "tuple[HierState, TimeStep] | None" = None,
             faults=None, ptrace: Trace | None = None,
             ) -> tuple[HierState, TimeStep]:
    """Step plus the fused auto-reset of :func:`..env.vec_step`: where an
    episode ended, the env continues from ``fresh = vec_reset(params,
    traces)`` (built anew when not given). ``faults`` is refused, as JAX
    refuses it; ``ptrace`` is :func:`step`'s."""
    _refuse_faults(faults)
    if ptrace is None:
        ptrace = pod_traces(traces, params.n_pods)
    stepped, ts = step(params, state, traces, actions, ptrace)
    fresh_state, fresh_ts = (reset(params, traces, ptrace) if fresh is None
                             else fresh)
    return env_lib.auto_reset(stepped, ts, fresh_state, fresh_ts)


def env_module(params):
    """The env module that steps ``params``: this one for
    :class:`HierParams`, :mod:`.env` otherwise. Both offer ``reset``,
    ``step``, ``vec_reset`` and ``vec_step`` with the same signatures."""
    return sys.modules[__name__] if isinstance(params, HierParams) \
        else env_lib


def vec_stepper(params, traces: Trace, faults=None):
    """``(state, actions, fresh) -> (state', ts)``: the ``vec_step`` of
    ``params``' env on the fixed batch ``traces`` (under the flat env's
    ``faults``), with what depends on the traces alone (the
    hierarchical env's ``pod_traces``) built once for every step of a
    rollout."""
    if not isinstance(params, HierParams):
        return lambda state, actions, fresh=None: env_lib.vec_step(
            params, state, traces, actions, fresh, faults)
    _refuse_faults(faults)
    ptrace = pod_traces(traces, params.n_pods)
    return lambda state, actions, fresh=None: vec_step(
        params, state, traces, actions, fresh, ptrace=ptrace)
