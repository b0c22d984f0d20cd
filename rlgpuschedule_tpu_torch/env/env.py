"""Batched cluster environment (L2) of the port.

Counterpart of the JAX package's ``env/env.py``. An episode is the
replay of one trace window; the action mask rules out infeasible
placements. The JAX package writes ``reset``/``step`` per cluster and
``vmap``s them into ``vec_reset``/``vec_step``; here ``reset`` and
``step`` are already batched over the leading cluster axis, so
``vec_reset`` is ``reset`` and ``vec_step`` is ``step`` plus the fused
auto-reset the JAX ``vec_step`` performs.

Every function takes ``faults``: a batched :class:`..sim.faults
.FaultSchedule` (or :class:`..domains.DomainSchedule`) threaded next to
the traces, or ``None`` for a healthy fixed cluster. An auto-reset
restarts the episode at clock 0 under the same schedule (fault times are
episode-relative, as submits are).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, NamedTuple, Sequence

import torch

from ..sim import core
from ..sim.core import SimParams, SimState, StepInfo, Trace
from ..sim.faults import FaultRegime, FaultSchedule
from ..traces.records import ArrayTrace
from . import obs as obs_lib
from . import rewards as reward_lib


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Static env configuration."""
    sim: SimParams
    obs_kind: Literal["flat", "grid", "graph"] = "flat"
    reward_kind: Literal["jct", "fair"] = "jct"
    n_tenants: int = 1            # the fairness reward's tenant bins
    time_scale: float = 600.0     # normalizes times in observations
    reward_scale: float = 1000.0  # divides reward magnitudes
    place_bonus: float = 0.0      # potential-based shaping (rewards.py)
    preempt_cost: float = 0.0     # anti-stall preemption charge (rewards.py)
    horizon: int = 512            # max decision steps per episode
    # the fault distribution the env's schedules are drawn from (the
    # drawn schedule is data passed beside the traces); None = healthy
    fault_process: FaultRegime | None = None
    # append per-node health (1/slowdown while up, 0 while drained) to
    # the flat observation, so a policy can learn to route around drains
    fault_obs: bool = False
    # the domain distribution (a domains.DomainSpec) the env's cluster
    # draws come from; None = the fixed cluster
    domain_process: object = None
    # append per-node geometry (capacity / gpus_per_node) to the flat
    # observation, after the health channel
    domain_obs: bool = False

    def __post_init__(self):
        if self.obs_kind not in ("flat", "grid", "graph"):
            raise ValueError(f"unknown obs_kind {self.obs_kind!r}")
        if self.reward_kind not in ("jct", "fair"):
            raise ValueError(f"unknown reward_kind {self.reward_kind!r}")
        if self.fault_obs and self.obs_kind != "flat":
            raise ValueError(
                f"fault_obs appends per-node health to the FLAT "
                f"observation; obs_kind={self.obs_kind!r} pins its "
                f"feature layout (train grid/graph fault policies "
                f"without health visibility, or use flat)")
        if self.domain_obs and self.obs_kind != "flat":
            raise ValueError(
                f"domain_obs appends per-node geometry to the FLAT "
                f"observation; obs_kind={self.obs_kind!r} pins its "
                f"feature layout")

    @property
    def n_actions(self) -> int:
        return self.sim.n_actions

    def obs_shape(self) -> tuple[int, ...]:
        """Per-cluster observation shape (no leading E)."""
        s, k, r = self.sim, self.sim.queue_len, self.sim.preempt_len
        if self.obs_kind == "flat":
            n_health = s.n_nodes if self.fault_obs else 0
            n_geom = s.n_nodes if self.domain_obs else 0
            return (s.n_nodes + 4 * k + 4 * r + 2 + n_health + n_geom,)
        if self.obs_kind == "grid":
            return (s.n_nodes + k + r, s.gpus_per_node, 2)
        return (s.n_nodes + k + r, obs_lib.GRAPH_FEATURES)


class EnvState(NamedTuple):
    sim: SimState
    t: torch.Tensor  # i32[E] decision steps taken in the episode


class TimeStep(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    action_mask: torch.Tensor
    info: StepInfo


_OBS = {"flat": obs_lib.flat_obs, "grid": obs_lib.grid_obs,
        "graph": obs_lib.graph_obs}


def build_obs(params: EnvParams, sim: SimState, trace: Trace,
              queue: torch.Tensor | None = None,
              run_queue: torch.Tensor | None = None,
              faults: FaultSchedule | None = None) -> torch.Tensor:
    """The observation; the health and geometry channels are appended
    last (in that order), so the prefix is laid out as the fixed-cluster
    observation is. With ``faults=None`` both read a healthy full
    cluster."""
    obs = _OBS[params.obs_kind](params.sim, sim, trace, params.time_scale,
                                queue, run_queue)
    parts = [obs]
    if params.fault_obs:
        parts.append(obs_lib.node_health(params.sim, sim, faults))
    if params.domain_obs:
        parts.append(obs_lib.node_geometry(params.sim, sim, faults))
    return torch.cat(parts, dim=1) if len(parts) > 1 else obs


def _observe(params: EnvParams, sim: SimState, trace: Trace,
             faults: FaultSchedule | None = None,
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(obs, action_mask), sharing one pending queue (and, for
    preemptive configs, one running queue) between the two."""
    queue = core.pending_queue(params.sim, sim)
    run_queue = (core.running_queue(params.sim, sim, trace)
                 if params.sim.preempt_len else None)
    return (build_obs(params, sim, trace, queue, run_queue, faults),
            core.action_mask(params.sim, sim, trace, queue, run_queue,
                             faults))


def reset(params: EnvParams, trace: Trace,
          faults: FaultSchedule | None = None) -> tuple[EnvState, TimeStep]:
    # a domain schedule's capacity is the initial free vector
    sim = core.init_state(params.sim, trace, faults)
    E = sim.clock.shape[0]
    dev = sim.clock.device
    state = EnvState(sim=sim,
                     t=torch.zeros(E, dtype=torch.int32, device=dev))
    obs, mask = _observe(params, sim, trace, faults)
    false = torch.zeros(E, dtype=torch.bool, device=dev)
    ts = TimeStep(
        obs=obs,
        reward=torch.zeros(E, dtype=torch.float32, device=dev),
        done=false,
        action_mask=mask,
        info=StepInfo(placed=false,
                      dt=torch.zeros(E, dtype=torch.float32, device=dev),
                      in_system_before=core.in_system(sim),
                      done=false, preempted=false, first_placed=false),
    )
    return state, ts


def step(params: EnvParams, state: EnvState, trace: Trace,
         action: torch.Tensor,
         faults: FaultSchedule | None = None) -> tuple[EnvState, TimeStep]:
    sim, info = core.rl_step(params.sim, state.sim, trace, action, faults)
    if params.reward_kind == "fair":
        reward = reward_lib.reward_fair(state.sim, trace, info,
                                        params.n_tenants,
                                        params.reward_scale)
    else:
        reward = reward_lib.reward_jct(info, params.reward_scale,
                                       params.place_bonus)
    # the anti-stall charge belongs to the action space, not to one
    # reward function: applied after the reward. Without preempt slots
    # and without faults no job is placed twice, the charge is exactly
    # -0.0 and leaves the reward's bits as they are, so it is not
    # computed there (JAX computes it and XLA folds it away). A drain
    # kills jobs back to the queue, and their re-placement is charged
    if params.preempt_cost and (params.sim.preempt_len
                                or faults is not None):
        reward = reward + reward_lib.preempt_charge(info,
                                                    params.preempt_cost)
    t = state.t + 1
    done = info.done | (t >= params.horizon)
    obs, mask = _observe(params, sim, trace, faults)
    return EnvState(sim=sim, t=t), TimeStep(obs=obs, reward=reward,
                                            done=done, action_mask=mask,
                                            info=info)


def auto_reset(stepped_state: EnvState, ts: TimeStep, fresh_state: EnvState,
               fresh_ts: TimeStep) -> tuple[EnvState, TimeStep]:
    """Where an episode ended, continue from the fresh reset (state,
    obs, mask from the fresh episode; reward and done from the finished
    one)."""
    new_state = core.select(ts.done, fresh_state, stepped_state)
    obs = core.select(ts.done, fresh_ts.obs, ts.obs)
    mask = core.select(ts.done, fresh_ts.action_mask, ts.action_mask)
    return new_state, ts._replace(obs=obs, action_mask=mask)


# the port's reset is batched over clusters already
vec_reset = reset


def vec_step(params: EnvParams, state: EnvState, traces: Trace,
             actions: torch.Tensor,
             fresh: "tuple[EnvState, TimeStep] | None" = None,
             faults: FaultSchedule | None = None,
             ) -> tuple[EnvState, TimeStep]:
    """Step plus fused auto-reset: where an episode ended, the cluster
    continues from a fresh reset of its trace (under the same
    ``faults``). The reset depends only on the traces and the schedules,
    so a caller stepping in a loop passes ``fresh = vec_reset(params,
    traces, faults)`` built once; without it every step builds the
    reset anew."""
    stepped, ts = step(params, state, traces, actions, faults)
    fresh_state, fresh_ts = (reset(params, traces, faults) if fresh is None
                             else fresh)
    return auto_reset(stepped, ts, fresh_state, fresh_ts)


def stack_traces(traces: Sequence[ArrayTrace], params,
                 device: "torch.device | str | None" = None) -> Trace:
    """Stack per-cluster trace windows (one ``max_jobs``) into a batched
    device Trace, checking gang sizes against capacity: the cluster's
    for ``EnvParams`` or ``SimParams``, one pod's for the hierarchical
    env's ``HierParams``."""
    if isinstance(params, EnvParams):
        sim_params = params.sim
    else:
        sim_params = getattr(params, "pod_sim", params)
    return Trace.from_array_traces(traces, sim_params, device)
