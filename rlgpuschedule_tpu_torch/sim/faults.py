"""Seeded cluster fault process (L1) of the port: node drains and
stragglers as data.

Counterpart of the JAX package's ``sim/faults.py``. A
:class:`FaultSchedule` is a trace-like set of per-node drain windows and
slowdown factors. The samplers and the validation are host numpy, a copy
of JAX's, so one seed gives the same schedule bit for bit in both
packages. The consumers (:func:`node_up`, :func:`next_transition`,
:func:`job_stretch`, :func:`effective_free`) take schedules batched over
the leading cluster axis ``E`` (``[E, N, W]`` windows, ``[E, N]``
slowdowns, as :func:`stack_fault_schedules` uploads them) against a
clock of ``[E]``; :mod:`.core` folds them into its masks.

Semantics (shared with :class:`.oracle.OracleSim`):

- a node is down on every half-open interval ``[down_start,
  down_end)`` of its row. While down its free GPUs are invisible to
  placement, and a job holding an allocation on it is killed back to
  PENDING at the drain instant with its attained service kept;
- a straggler node (``slowdown > 1``) stretches remaining work by that
  factor, and a gang runs at its slowest node's speed;
- drain starts and node returns are events: the decision loop stops at
  each transition and never integrates across one.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..device import resolve_device

INF = float("inf")


class FaultSchedule(NamedTuple):
    """Per-node fault trace (``W`` drain windows per node, +inf padding;
    rows sorted by ``down_start``). Host numpy arrays ``[N, W]`` and
    ``[N]`` for one cluster, or device tensors with a leading ``E``."""
    down_start: "np.ndarray | torch.Tensor"  # f32 drain instants
    down_end: "np.ndarray | torch.Tensor"    # f32 return instants
    slowdown: "np.ndarray | torch.Tensor"    # f32 work stretch (1 = healthy)

    @property
    def n_nodes(self) -> int:
        return int(self.down_start.shape[-2])


def no_faults(n_nodes: int, n_waves: int = 1) -> FaultSchedule:
    """The permanently healthy schedule (host arrays), the identity of
    every consumer."""
    return FaultSchedule(
        down_start=np.full((n_nodes, n_waves), np.inf, np.float32),
        down_end=np.full((n_nodes, n_waves), np.inf, np.float32),
        slowdown=np.ones((n_nodes,), np.float32))


# ---- batched consumption (device tensors, leading E) ------------------------

def node_up(faults: FaultSchedule, t: torch.Tensor) -> torch.Tensor:
    """``bool[E, N]``: node serving at clock ``t[e]`` (down on
    ``[start, end)``)."""
    tt = t[:, None, None]
    return ~((faults.down_start <= tt) & (tt < faults.down_end)).any(-1)


def next_transition(faults: FaultSchedule, t: torch.Tensor) -> torch.Tensor:
    """``f32[E]``: the earliest drain start or node return strictly after
    ``t[e]`` (+inf if none): a transition is an event."""
    tt = t[:, None, None]
    start = torch.where(faults.down_start > tt, faults.down_start, INF)
    end = torch.where(faults.down_end > tt, faults.down_end, INF)
    return torch.minimum(start.amin((1, 2)), end.amin((1, 2)))


def job_stretch(faults: FaultSchedule, alloc: torch.Tensor) -> torch.Tensor:
    """``f32[E, J]`` work stretch per job: a gang runs at its slowest
    node's speed; 1 for a job holding no allocation."""
    return torch.where(alloc > 0, faults.slowdown[:, None, :],
                       1.0).amax(2)


def effective_free(faults: "FaultSchedule | None", free: torch.Tensor,
                   t: torch.Tensor) -> torch.Tensor:
    """Placement's view of ``free`` ``[E, N]``: a drained node offers
    nothing. ``faults=None`` is the identity (no op is issued)."""
    if faults is None:
        return free
    return torch.where(node_up(faults, t), free, 0)


# ---- host-side validation ---------------------------------------------------

def validate_fault_schedule(n_nodes: int, faults: FaultSchedule,
                            ) -> FaultSchedule:
    """Raise on a malformed schedule (end before start, unsorted
    windows, a node count that is not the cluster's, a speed-up), which
    in the simulator would show only as wrong drain masks. Returns the
    schedule as host numpy arrays (the three fault fields)."""
    start = np.asarray(faults.down_start, np.float32)
    end = np.asarray(faults.down_end, np.float32)
    slow = np.asarray(faults.slowdown, np.float32)
    if start.ndim != 2 or start.shape != end.shape:
        raise ValueError(
            f"fault schedule wants down_start/down_end of matching shape "
            f"[n_nodes, n_waves]; got {start.shape} vs {end.shape}")
    if start.shape[0] != n_nodes or slow.shape != (n_nodes,):
        raise ValueError(
            f"fault schedule is shaped for {start.shape[0]} node(s) with "
            f"slowdown {slow.shape}; the cluster has {n_nodes}")
    finite = np.isfinite(start)
    if (start[finite] < 0).any():
        raise ValueError("drain start times must be >= 0")
    if np.isnan(start).any() or np.isnan(end).any():
        raise ValueError("fault schedule times must not be NaN")
    if (end[finite] <= start[finite]).any():
        raise ValueError(
            "drain durations must be positive (down_end > down_start "
            "for every finite drain window)")
    if (np.isfinite(end) & ~finite).any():
        raise ValueError("a node-return time without a matching drain "
                         "start (finite down_end under +inf down_start)")
    # +inf padding maps to fmax: inf - inf gives no NaN diff, and padding
    # before a finite window still reads as unsorted
    bounded = np.where(finite, start, np.finfo(np.float32).max)
    if (np.diff(bounded, axis=1) < 0).any():
        raise ValueError("per-node drain windows must be sorted by start "
                         "time (pad with +inf at the tail)")
    if (~np.isfinite(slow)).any() or (slow < 1.0).any():
        raise ValueError("slowdown factors must be finite and >= 1.0 "
                         "(1.0 = healthy; a speed-UP is not a fault)")
    return FaultSchedule(start, end, slow)


def fault_schedule_from_events(n_nodes: int, node: Sequence[int],
                               start: Sequence[float],
                               duration: Sequence[float],
                               slowdown: "Sequence[float] | None" = None,
                               n_waves: "int | None" = None,
                               ) -> FaultSchedule:
    """Pack an event list (node id, drain start, outage length) into the
    per-node form, validating as it goes: the ingest path of a
    hand-written chaos script."""
    node = np.asarray(node, np.int64)
    start = np.asarray(start, np.float64)
    duration = np.asarray(duration, np.float64)
    if not (node.shape == start.shape == duration.shape):
        raise ValueError("node/start/duration must have matching lengths")
    if node.size and (node.min() < 0 or node.max() >= n_nodes):
        raise ValueError(
            f"drain event node id(s) out of range [0, {n_nodes})")
    if (duration <= 0).any():
        raise ValueError("drain durations must be positive")
    if (start < 0).any():
        raise ValueError("drain start times must be >= 0")
    per_node = max((np.bincount(node, minlength=n_nodes).max()
                    if node.size else 0), 1)
    W = int(n_waves) if n_waves is not None else int(per_node)
    if per_node > W:
        raise ValueError(f"{int(per_node)} drain window(s) on one node "
                         f"exceed n_waves={W}")
    fs = no_faults(n_nodes, W)
    for n in range(n_nodes):
        mine = node == n
        order = np.argsort(start[mine], kind="stable")
        s = start[mine][order]
        fs.down_start[n, :len(s)] = s
        fs.down_end[n, :len(s)] = s + duration[mine][order]
    if slowdown is not None:
        fs = fs._replace(slowdown=np.asarray(slowdown, np.float32))
    return validate_fault_schedule(n_nodes, fs)


# ---- seeded fault regimes ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultRegime:
    """A named fault distribution; :func:`sample_fault_schedule` draws
    seeded schedules from it. Times are fractions of the episode
    horizon, so a regime carries across trace scales."""
    name: str
    p_drain: float = 0.0         # per-node chance of drain window(s)
    n_waves: int = 1             # drain windows per drained node (W)
    outage_frac: float = 0.12    # mean outage length / horizon
    storm: bool = False          # correlated starts: one instant per wave
    p_straggler: float = 0.0     # per-node chance of a slowdown factor
    slowdown_min: float = 1.5
    slowdown_max: float = 4.0


# the chaos matrix's regimes: a clean control, uncorrelated single
# drains, correlated drain storms and pure stragglers
FAULT_REGIMES: dict[str, FaultRegime] = {
    "none": FaultRegime("none"),
    "sporadic": FaultRegime("sporadic", p_drain=0.25),
    "storm": FaultRegime("storm", p_drain=0.6, n_waves=2,
                         outage_frac=0.08, storm=True),
    "straggler": FaultRegime("straggler", p_straggler=0.4),
}


def resolve_regime(regime: "FaultRegime | str") -> FaultRegime:
    if isinstance(regime, FaultRegime):
        return regime
    if regime not in FAULT_REGIMES:
        raise ValueError(f"unknown fault regime {regime!r}; known: "
                         f"{sorted(FAULT_REGIMES)}")
    return FAULT_REGIMES[regime]


def sample_fault_schedule(n_nodes: int, regime: "FaultRegime | str",
                          seed, horizon_s: float) -> FaultSchedule:
    """One seeded host draw from ``regime`` over ``[0, horizon_s)``.
    ``seed`` is an int or a tuple of ints (e.g. ``(seed, env)``); the
    regime's name is folded in, so one base seed gives independent draws
    per regime. The generator's entropy is JAX's, so the draw is its bit
    for bit."""
    regime = resolve_regime(regime)
    if not (np.isfinite(horizon_s) and horizon_s > 0):
        raise ValueError(f"horizon_s must be finite and > 0, got "
                         f"{horizon_s}")
    entropy = list(seed) if isinstance(seed, (tuple, list)) else [int(seed)]
    rng = np.random.default_rng([zlib.crc32(regime.name.encode()),
                                 *[int(s) & 0xFFFFFFFF for s in entropy]])
    W = max(int(regime.n_waves), 1)
    fs = no_faults(n_nodes, W)
    drained = rng.random(n_nodes) < regime.p_drain
    mean_outage = max(regime.outage_frac * horizon_s, 1e-3)
    for w in range(W):
        # a storm's drained nodes fail within a tight jitter of one
        # instant; sporadic drains start anywhere in the window
        if regime.storm:
            base = rng.uniform(0.1, 0.6) * horizon_s
            starts = base + rng.exponential(0.01 * horizon_s,
                                            size=n_nodes)
        else:
            starts = rng.uniform(0.05, 0.7, size=n_nodes) * horizon_s
        outages = np.maximum(rng.exponential(mean_outage, size=n_nodes),
                             1e-3)
        fs.down_start[:, w] = np.where(drained, starts, np.inf)
        fs.down_end[:, w] = np.where(drained, starts + outages, np.inf)
    # re-sort each node's windows by start (wave draws are unordered)
    order = np.argsort(fs.down_start, axis=1, kind="stable")
    fs = FaultSchedule(np.take_along_axis(fs.down_start, order, axis=1),
                       np.take_along_axis(fs.down_end, order, axis=1),
                       fs.slowdown)
    straggler = rng.random(n_nodes) < regime.p_straggler
    fs.slowdown[:] = np.where(
        straggler,
        rng.uniform(regime.slowdown_min, regime.slowdown_max,
                    size=n_nodes), 1.0).astype(np.float32)
    return validate_fault_schedule(n_nodes, fs)


def sample_env_fault_schedules(n_nodes: int, regime: "FaultRegime | str",
                               seed: int, n_envs: int, horizon_s: float,
                               device: "torch.device | str | None" = None,
                               ) -> FaultSchedule:
    """Batched device schedules ``[E, ...]``: env ``e`` draws from
    ``(seed, e)``."""
    return stack_fault_schedules(
        [sample_fault_schedule(n_nodes, regime, (seed, e), horizon_s)
         for e in range(n_envs)], device)


def stack_fault_schedules(schedules: Sequence[NamedTuple],
                          device: "torch.device | str | None" = None):
    """Stack per-env host schedules (fault or domain, one type) into one
    batched schedule of device tensors (leading ``E``) on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    first = schedules[0]
    return type(first)(*(
        torch.from_numpy(np.stack([np.asarray(getattr(s, f))
                                   for s in schedules])).to(dev)
        for f in first._fields))


def schedule_stats(faults: FaultSchedule) -> dict:
    """Host summary of one (or a batched) schedule, what the chaos
    matrix's ``env_fault`` events carry."""
    start = _host(faults.down_start)
    end = _host(faults.down_end)
    slow = _host(faults.slowdown)
    finite = np.isfinite(start)
    bounded = finite & np.isfinite(end)
    return {
        "n_drains": int(finite.sum()),
        "n_permanent": int((finite & ~np.isfinite(end)).sum()),
        "total_downtime_s": float((end[bounded] - start[bounded]).sum()),
        "n_stragglers": int((slow > 1.0).sum()),
        "max_slowdown": float(slow.max()) if slow.size else 1.0,
    }


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, np.float64)


def fault_horizon(windows) -> float:
    """Rough sim-time span of a window set, the interval fault windows
    should land in so drains meet live episodes: the arrivals plus four
    mean service times."""
    t = 0.0
    for w in windows:
        valid = np.asarray(w.valid)
        if not valid.any():
            continue
        submit = np.asarray(w.submit, np.float64)[valid]
        duration = np.asarray(w.duration, np.float64)[valid]
        t = max(t, float(submit.max()) + 4.0 * float(duration.mean()))
    return max(t, 1.0)
