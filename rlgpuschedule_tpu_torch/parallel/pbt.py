"""Population-based training controller (L5) of the port: config 5's
exploit/explore.

Counterpart of ``PBTConfig``, ``PBTDecision``, ``exploit_explore``,
``gather_members`` and ``PBTController`` in the JAX package's
``parallel/pbt.py``. Periodically the members are ranked by fitness;
the bottom quantile copies weights, optimizer state and hyperparameters
from a random top-quantile member (exploit) and perturbs the copied
hyperparameters (explore). The decision logic is host numpy, the same
code as JAX's, so the same fitness and seed give the same decisions bit
for bit. The weight transfer copies each exploited member's policy and
Adam state from a snapshot of its source taken before any write (JAX's
gather reads the whole stack as it was), on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .population import HPARAM_BOUNDS, HParams, MemberState


@dataclasses.dataclass(frozen=True)
class PBTConfig:
    ready_iters: int = 10        # iterations between exploit/explore rounds
    exploit_frac: float = 0.25   # bottom quantile replaced from top quantile
    perturb_low: float = 0.8     # explore: multiply each hparam by
    perturb_high: float = 1.25   #   low or high, chosen uniformly
    seed: int = 0


@dataclasses.dataclass
class PBTDecision:
    """One exploit/explore round's outcome (host-side, for logging)."""
    src: np.ndarray        # i64[P]: member i copies from src[i] (i = keep)
    exploited: np.ndarray  # bool[P]
    hparams: HParams       # post-explore f32 [P] hparams


def exploit_explore(rng: np.random.Generator, fitness: np.ndarray,
                    hparams: HParams, cfg: PBTConfig) -> PBTDecision:
    """Truncation-selection PBT: the bottom ``exploit_frac`` of members
    copy a uniformly chosen top-``exploit_frac`` member and perturb its
    hyperparameters.

    Non-finite fitness (a diverged member) is dead, not merely last:
    every dead member is exploited from the best finite member whatever
    the quota, and winners are drawn from finite members only. With no
    finite member at all, dead members keep their state."""
    raw = np.asarray(fitness, np.float64)
    finite = np.isfinite(raw)
    fitness = np.where(finite, raw, -np.inf)
    n = len(fitness)
    k = max(int(np.floor(n * cfg.exploit_frac)), 1) if n > 1 else 0
    order = np.argsort(fitness)           # ascending: losers first
    losers = order[:k]
    winners = order[n - k:][finite[order[n - k:]]] if k else order[:0]
    src = np.arange(n)
    if k and len(winners):
        src[losers] = rng.choice(winners, size=k)
    if finite.any() and not finite.all():
        # dead members re-seed from the best member, quota or not
        src[~finite] = int(np.argmax(fitness))
    exploited = src != np.arange(n)

    new_hp = {}
    for name in HParams._fields:
        vals = np.array(np.asarray(getattr(hparams, name))[src],
                        dtype=np.float32)
        factors = rng.choice([cfg.perturb_low, cfg.perturb_high], size=n)
        lo, hi = HPARAM_BOUNDS[name]
        vals = np.where(exploited, np.clip(vals * factors, lo, hi), vals)
        new_hp[name] = vals.astype(np.float32)
    return PBTDecision(src=src, exploited=exploited,
                       hparams=HParams(**new_hp))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def gather_members(members: Sequence[MemberState],
                   src: np.ndarray) -> list[MemberState]:
    """Copy member ``src[i]``'s policy parameters and optimizer state
    (Adam's moments and step) into member ``i`` (the exploit transfer).
    Every source is read as it was before the gather: its snapshot is
    cloned before any write, and each destination gets tensors of its
    own, so no two members ever share one."""
    src = np.asarray(src)
    snap = {int(s): (_clone(members[s].net.state_dict()),
                     _clone(members[s].opt.state_dict()))
            for i, s in enumerate(src) if s != i}
    for i, s in enumerate(src):
        if s == i:
            continue
        params, opt = snap[int(s)]
        members[i].net.load_state_dict(params)
        members[i].opt.load_state_dict(_clone(opt))
    return list(members)


def best_member_index(mean_fitness: np.ndarray) -> int:
    """The fittest member by windowed mean fitness (NaN ranks worst, the
    exploit's ordering)."""
    f = np.asarray(mean_fitness, np.float64)
    return int(np.nanargmax(np.where(np.isnan(f), -np.inf, f)))


class PBTController:
    """Host-side fitness accounting and periodic exploit/explore.

    Per training iteration ``i``::

        ctrl.record(metrics.mean_reward)        # [P] per-member fitness
        out = ctrl.maybe_update(i, members, hparams)
        if out is not None:
            members, hparams, decision = out
    """

    def __init__(self, n_pop: int, cfg: PBTConfig = PBTConfig()):
        self.cfg = cfg
        self.n_pop = n_pop
        self._rng = np.random.default_rng(cfg.seed)
        # fitness arrives as device tensors and is not synced on record:
        # the host loop stays ahead of the card until the ready boundary
        self._pending: list = []
        self._fitness_sum = np.zeros(n_pop)
        self._fitness_n = 0
        self.history: list[PBTDecision] = []

    def record(self, fitness) -> None:
        """Queue one iteration's per-member fitness ``[P]`` (a tensor on
        any device, or an array); no device sync."""
        self._pending.append(fitness)

    def _drain(self) -> None:
        if not self._pending:
            return
        if all(isinstance(f, torch.Tensor) for f in self._pending):
            window = torch.stack(self._pending).cpu().numpy()  # one copy
        else:
            window = np.stack([np.asarray(f) for f in self._pending])
        for f in window.astype(np.float64):
            self._fitness_sum += f
            self._fitness_n += 1
        self._pending.clear()

    @property
    def has_fitness(self) -> bool:
        """Whether any fitness has been recorded (now or in a decided
        window)."""
        return bool(self._pending or self._fitness_n or self.history)

    @property
    def mean_fitness(self) -> np.ndarray:
        """Per-member mean fitness over the current window, or, right
        after an exploit/explore round reset it, over the window that
        round was decided on."""
        self._drain()
        if self._fitness_n == 0 and self.history:
            return self._last_window_fitness
        return self._fitness_sum / max(self._fitness_n, 1)

    def state_dict(self) -> dict:
        """JSON-able snapshot of everything the next decision depends on:
        the numpy bit generator's state, the fitness window and the
        decision history; JAX's keys, so either package reads the
        other's."""
        self._drain()
        out = {
            "rng": self._rng.bit_generator.state,
            "fitness_sum": [float(x) for x in self._fitness_sum],
            "fitness_n": int(self._fitness_n),
            "history": [
                {"src": [int(x) for x in d.src],
                 "exploited": [bool(x) for x in d.exploited],
                 "hparams": {k: [float(x) for x in np.asarray(v)]
                             for k, v in d.hparams._asdict().items()}}
                for d in self.history],
        }
        if hasattr(self, "_last_window_fitness"):
            out["last_window_fitness"] = [float(x) for x in
                                          self._last_window_fitness]
        return out

    def load_state_dict(self, state: dict | None) -> None:
        """Inverse of :meth:`state_dict`; a no-op on an empty or None
        dict."""
        if not state:
            return
        self._rng.bit_generator.state = state["rng"]
        self._fitness_sum = np.asarray(state["fitness_sum"], np.float64)
        self._fitness_n = int(state["fitness_n"])
        self._pending.clear()
        self.history = [
            PBTDecision(
                src=np.asarray(d["src"], np.int64),
                exploited=np.asarray(d["exploited"], bool),
                hparams=HParams(**{k: np.asarray(v, np.float32)
                                   for k, v in d["hparams"].items()}))
            for d in state["history"]]
        if "last_window_fitness" in state:
            self._last_window_fitness = np.asarray(
                state["last_window_fitness"], np.float64)

    def maybe_update(self, iteration: int, members, hparams: HParams):
        """After every ``ready_iters`` recorded iterations, one
        exploit/explore round over the members; returns ``(members,
        hparams, decision)``, or None when not due (and then no device
        sync). ``iteration`` is not consulted: readiness depends only on
        the recorded window, which survives a checkpoint, so a resumed
        run decides where the uninterrupted one did."""
        if len(self._pending) + self._fitness_n < self.cfg.ready_iters:
            return None
        self._drain()
        fitness = self._fitness_sum / max(self._fitness_n, 1)
        decision = exploit_explore(self._rng, fitness, hparams, self.cfg)
        self._last_window_fitness = fitness
        self._fitness_sum[:] = 0.0
        self._fitness_n = 0
        self.history.append(decision)
        if decision.exploited.any():
            members = gather_members(members, decision.src)
        return members, decision.hparams, decision
