"""Domain randomization (L6) of the port: the scenario space as data.

Counterpart of the JAX package's ``domains/schedule.py``. A
:class:`DomainSchedule` is a :class:`..sim.faults.FaultSchedule` with a
fourth field, the per-node GPU ``capacity``; every fault consumer reads
its fields by name, so a domain schedule rides the ``faults`` argument
of the simulator, the env, the rollout and the replays unchanged, and
its capacity becomes the initial free vector
(:func:`..sim.core.init_state`). Hardware speed rides the straggler
``slowdown``. The arrival half of a draw (load, bursts, a diurnal
cycle, duration scaling) is realized as trace windows by
:func:`..traces.fit.gen_domain_window`.

:data:`DOMAIN_REGIMES` names the scenario distributions and
:func:`sample_domain` draws seeded :class:`DomainDraw`s from them on the
host, with JAX's generator entropy, so a draw is JAX's bit for bit.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..sim.faults import (FaultSchedule, no_faults, stack_fault_schedules,
                          validate_fault_schedule)


class DomainSchedule(NamedTuple):
    """Per-env domain data: the fault triple plus per-node capacity. Host
    arrays ``[N, W]``/``[N]``, or device tensors with a leading ``E``."""
    down_start: "np.ndarray | torch.Tensor"  # f32 drain instants
    down_end: "np.ndarray | torch.Tensor"    # f32 return instants
    slowdown: "np.ndarray | torch.Tensor"    # f32 speed (faults x hardware)
    capacity: "np.ndarray | torch.Tensor"    # i32 usable GPUs (0 = absent)

    @property
    def n_nodes(self) -> int:
        return int(self.down_start.shape[-2])


# ---- named domain regimes ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DomainSpec:
    """A named scenario distribution; :func:`sample_domain` draws seeded
    :class:`DomainDraw`s from it. The geometry and speed knobs shape the
    cluster, the load, burst, diurnal and duration knobs the arrivals."""
    name: str
    # geometry: per-node capacity ~ round(U[capacity_min_frac, 1] * G),
    # then each node absent outright with p_node_off (capacity 0)
    capacity_min_frac: float = 1.0
    p_node_off: float = 0.0
    # hardware heterogeneity: per-node chance of a permanent speed factor
    # in [slowdown_min, slowdown_max] (rides the straggler machinery)
    p_hetero: float = 0.0
    slowdown_min: float = 1.5
    slowdown_max: float = 4.0
    # arrivals: offered load ~ U[load_min, load_max], diurnal
    # modulation, and a flash crowd of this fraction of the jobs
    load_min: float = 1.1
    load_max: float = 1.1
    diurnal: bool = False
    burst_frac: float = 0.0
    # job mix: duration median multiplier ~ U[min, max]
    duration_scale_min: float = 1.0
    duration_scale_max: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.capacity_min_frac <= 1.0:
            raise ValueError(
                f"capacity_min_frac must be in (0, 1], got "
                f"{self.capacity_min_frac}")
        for p_name in ("p_node_off", "p_hetero", "burst_frac"):
            p = getattr(self, p_name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{p_name} must be in [0, 1], got {p}")
        if self.p_node_off >= 1.0 and self.name != "_impossible":
            raise ValueError("p_node_off=1 would draw empty clusters")
        if not 1.0 <= self.slowdown_min <= self.slowdown_max:
            raise ValueError(
                f"want 1 <= slowdown_min <= slowdown_max, got "
                f"[{self.slowdown_min}, {self.slowdown_max}]")
        if not 0.0 < self.load_min <= self.load_max:
            raise ValueError(f"want 0 < load_min <= load_max, got "
                             f"[{self.load_min}, {self.load_max}]")
        if not 0.0 < self.duration_scale_min <= self.duration_scale_max:
            raise ValueError(
                f"want 0 < duration_scale_min <= duration_scale_max, got "
                f"[{self.duration_scale_min}, {self.duration_scale_max}]")


# the generalization matrix's regimes: a fixed-cluster control (load
# pinned at the configs' 1.1), the broad training distribution, one
# regime per axis, and everything at once
DOMAIN_REGIMES: dict[str, DomainSpec] = {
    "none": DomainSpec("none"),
    "baseline": DomainSpec("baseline", load_min=0.8, load_max=1.2,
                           duration_scale_min=0.75,
                           duration_scale_max=1.5),
    "geom": DomainSpec("geom", capacity_min_frac=0.5, p_node_off=0.1,
                       load_min=0.9, load_max=1.1),
    "hetero": DomainSpec("hetero", p_hetero=0.4, load_min=0.9,
                         load_max=1.1),
    "overload": DomainSpec("overload", load_min=1.6, load_max=1.6),
    "flash": DomainSpec("flash", burst_frac=0.5, load_min=1.0,
                        load_max=1.2),
    "mixed": DomainSpec("mixed", capacity_min_frac=0.5, p_node_off=0.1,
                        p_hetero=0.4, load_min=0.8, load_max=1.4,
                        diurnal=True, burst_frac=0.25,
                        duration_scale_min=0.75, duration_scale_max=1.5),
}


def resolve_domain(spec: "DomainSpec | str") -> DomainSpec:
    if isinstance(spec, DomainSpec):
        return spec
    if spec not in DOMAIN_REGIMES:
        raise ValueError(f"unknown domain regime {spec!r}; known: "
                         f"{sorted(DOMAIN_REGIMES)}")
    return DOMAIN_REGIMES[spec]


# ---- seeded draws -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DomainDraw:
    """One host draw from a :class:`DomainSpec`: the cluster half
    (packed by :func:`domain_schedule`) and the arrival half (read by
    ``experiment.make_domain_windows``)."""
    spec_name: str
    capacity: np.ndarray    # i32[N] usable GPUs per node
    slowdown: np.ndarray    # f32[N] hardware speed factor (>= 1)
    load: float
    duration_scale: float
    burst_frac: float
    diurnal: bool

    @property
    def total_gpus(self) -> int:
        return int(self.capacity.sum())


def sample_domain(spec: "DomainSpec | str", n_nodes: int,
                  gpus_per_node: int, seed) -> DomainDraw:
    """One seeded host draw; ``seed`` is an int or a tuple of ints, and
    the spec's name is folded in (one base seed, independent draws per
    regime)."""
    spec = resolve_domain(spec)
    if n_nodes <= 0 or gpus_per_node <= 0:
        raise ValueError(f"want positive n_nodes/gpus_per_node, got "
                         f"{n_nodes}/{gpus_per_node}")
    entropy = list(seed) if isinstance(seed, (tuple, list)) else [int(seed)]
    rng = np.random.default_rng(
        [zlib.crc32(("domain:" + spec.name).encode()),
         *[int(s) & 0xFFFFFFFF for s in entropy]])
    frac = rng.uniform(spec.capacity_min_frac, 1.0, size=n_nodes)
    cap = np.maximum(np.rint(frac * gpus_per_node), 1).astype(np.int32)
    cap = np.where(rng.random(n_nodes) < spec.p_node_off, 0, cap)
    if cap.sum() == 0:
        # an empty cluster schedules nothing: keep the draw valid with
        # one full node (only tiny clusters hit this)
        cap[0] = gpus_per_node
    hetero = rng.random(n_nodes) < spec.p_hetero
    slow = np.where(hetero, rng.uniform(spec.slowdown_min,
                                        spec.slowdown_max, size=n_nodes),
                    1.0).astype(np.float32)
    return DomainDraw(
        spec_name=spec.name, capacity=cap, slowdown=slow,
        load=float(rng.uniform(spec.load_min, spec.load_max)),
        duration_scale=float(rng.uniform(spec.duration_scale_min,
                                         spec.duration_scale_max)),
        burst_frac=spec.burst_frac, diurnal=spec.diurnal)


def sample_env_domains(spec: "DomainSpec | str", n_nodes: int,
                       gpus_per_node: int, seed: int, n_envs: int,
                       ) -> list[DomainDraw]:
    """Per-env draws: env ``e`` draws from ``(seed, e)``."""
    return [sample_domain(spec, n_nodes, gpus_per_node, (seed, e))
            for e in range(n_envs)]


# ---- schedules --------------------------------------------------------------

def domain_schedule(draw: DomainDraw,
                    faults: FaultSchedule | None = None) -> DomainSchedule:
    """Pack a draw's cluster half into a host :class:`DomainSchedule`,
    composed with an optional fault schedule of the same cluster: the
    drain windows are the faults', and a node's speed factor is the
    larger of its hardware's and its straggling's."""
    n = len(draw.capacity)
    base = no_faults(n) if faults is None else faults
    if getattr(base, "n_nodes", n) != n:
        raise ValueError(f"fault schedule is shaped for {base.n_nodes} "
                         f"node(s); the domain draw has {n}")
    slow = np.maximum(np.asarray(base.slowdown, np.float32),
                      draw.slowdown).astype(np.float32)
    return DomainSchedule(
        down_start=np.asarray(base.down_start, np.float32),
        down_end=np.asarray(base.down_end, np.float32),
        slowdown=slow,
        capacity=np.asarray(draw.capacity, np.int32))


def validate_domain_schedule(n_nodes: int, gpus_per_node: int,
                             schedule: DomainSchedule) -> DomainSchedule:
    """The fault triple's checks plus the capacity's: shape ``[N]``,
    integral, within ``[0, gpus_per_node]``, a non-empty cluster.
    Returns host numpy arrays."""
    fs = validate_fault_schedule(n_nodes, schedule)
    cap = np.asarray(schedule.capacity)
    if cap.shape != (n_nodes,):
        raise ValueError(f"domain capacity must have shape ({n_nodes},); "
                         f"got {cap.shape}")
    if not np.issubdtype(cap.dtype, np.integer):
        raise ValueError(f"domain capacity must be integral GPUs, got "
                         f"dtype {cap.dtype}")
    if (cap < 0).any() or (cap > gpus_per_node).any():
        raise ValueError(
            f"per-node capacity must lie in [0, {gpus_per_node}] (the "
            f"static gpus_per_node bound the obs/action layout is built "
            f"for); got [{int(cap.min())}, {int(cap.max())}]")
    if cap.sum() <= 0:
        raise ValueError("domain capacity sums to zero GPUs — an empty "
                         "cluster can schedule nothing")
    return DomainSchedule(fs.down_start, fs.down_end, fs.slowdown,
                          cap.astype(np.int32))


def stack_domain_schedules(schedules: Sequence[DomainSchedule],
                           device: "torch.device | str | None" = None,
                           ) -> DomainSchedule:
    """Stack per-env host schedules into one batched device schedule
    (leading ``E``) on ``device`` (default ``cuda``)."""
    return stack_fault_schedules(schedules, device)


def domain_stats(draw: DomainDraw) -> dict:
    """Host summary of one draw, what the matrix's ``domain_cell``
    events carry."""
    cap = np.asarray(draw.capacity, np.int64)
    slow = np.asarray(draw.slowdown, np.float64)
    return {
        "spec": draw.spec_name,
        "total_gpus": int(cap.sum()),
        "n_nodes_off": int((cap == 0).sum()),
        "n_hetero": int((slow > 1.0).sum()),
        "max_slowdown": float(slow.max()) if slow.size else 1.0,
        "load": float(draw.load),
        "duration_scale": float(draw.duration_scale),
        "burst_frac": float(draw.burst_frac),
        "diurnal": bool(draw.diurnal),
    }
