"""Canary-gated promotion with automatic rollback: the flywheel's apply
path.

Counterpart of the JAX package's ``flywheel/canary.py``. A candidate's
weights replay a held-out logged window (:mod:`.flightlog`) next to the
incumbent's, both through :func:`..decision.policy_decision_full` with
the serving stall gate, and each replay is compared row by row with the
logged behavior actions. A slice where the candidate's agreement falls
more than ``tol`` below the incumbent's votes "regress"; ``hysteresis``
consecutive regressing slices block the promotion.

Promotion itself is the engine's or router's in-place weight swap with
its blessed re-warm; :class:`SLOWatchdog` then compares the live p99,
shed and recompile counts with what it learned before the swap and asks
for a rollback on a breach streak (at once on a recompile). Every
verdict goes into the :class:`PromotionLedger`, a crc-sidecar'd JSONL
file that either package reads.

The replay is one plain forward under ``torch.no_grad()`` on the
policy's device; JAX's weakly keyed cache of jitted replay programs has
no counterpart here. On the CPU the incumbent's replay of rows its own
engine logged agrees exactly; on the card the logged actions come from
the graph of each dispatch's bucket and the replay is one ``[N]``-row
forward, so a row whose top-two margin is below 1e-4 may differ.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import zlib
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..checkpoint import _crc32_file
from ..decision import (gate_stalled, policy_decision_full, preempt_slice,
                        stall_threshold)
from ..tree import leaves, tree_map
from .flightlog import FlightShard, unflatten_like

LEDGER_NAME = "promotions.jsonl"
P99_FACTOR = 1.5      # the watchdog's breach: live p99 over 1.5x baseline
EWMA_ALPHA = 0.2      # the watchdog's baseline forgetting factor


class LedgerCorruptError(RuntimeError):
    """The promotion ledger's sealed prefix fails its crc sidecar."""


def replay_decisions(policy: nn.Module, params, obs: Any, mask: Any,
                     stall, env_params=None):
    """Replay a logged window (host arrays or trees, a leading row axis)
    through the serving engines' gated decision rule under ``params`` (a
    state dict of ``policy``): ``(actions, log_prob, value)`` as host
    arrays. ``stall`` is ``i32[N]`` (None: zeros). One full-window
    forward on the policy's device."""
    dev = next(policy.parameters()).device
    put = lambda x: torch.from_numpy(
        np.require(x, requirements="W")).to(dev)
    obs_t, mask_t = tree_map(put, obs), tree_map(put, mask)
    n = int(np.asarray(leaves(mask)[0]).shape[0])
    pre = preempt_slice(env_params, dev) if env_params is not None else None
    if pre is not None:
        st = (np.zeros(n, np.int32) if stall is None
              else np.asarray(stall, np.int32))
        mask_t = gate_stalled(mask_t, put(st), stall_threshold(env_params),
                              pre)
    apply = lambda o, m: functional_call(policy, params, (o, m))
    with torch.no_grad():
        out = policy_decision_full(apply, obs_t, mask_t)
    return tree_map(lambda t: t.cpu().numpy(), out)


def action_agreement(a: Any, b: Any) -> np.ndarray:
    """Row-wise agreement of two action trees (or leaf lists): True where
    every head matches (``bool[N]``)."""
    agree = None
    for x, y in zip(leaves(a), leaves(b)):
        eq = np.asarray(x) == np.asarray(y)
        eq = eq.reshape(eq.shape[0], -1).all(axis=1)
        agree = eq if agree is None else (agree & eq)
    return agree


@dataclasses.dataclass
class CanaryReport:
    """One canary run's verdict and evidence."""
    verdict: str                     # "promote" | "blocked"
    rows: int
    slices: int
    incumbent_agreement: float       # against the logged actions, overall
    candidate_agreement: float
    regress_slices: int
    max_regress_streak: int
    per_slice: "list[dict]"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def run_canary(policy: nn.Module, incumbent_params, candidate_params,
               window: FlightShard, example_obs: Any, example_mask: Any,
               env_params=None, slices: int = 8, tol: float = 0.02,
               hysteresis: int = 2, registry=None, bus=None) -> CanaryReport:
    """Gate a candidate against the incumbent over a held-out logged
    ``window`` (e.g. ``read_flight_log(d).concat()``); the params are
    state dicts of ``policy``. Blocks when ``hysteresis`` consecutive
    slices regress (the candidate's agreement with the logged actions
    more than ``tol`` below the incumbent's on the same slice)."""
    if slices < 1:
        raise ValueError(f"slices must be >= 1, got {slices}")
    if hysteresis < 1:
        raise ValueError(f"hysteresis must be >= 1, got {hysteresis}")
    obs = unflatten_like(example_obs, window.obs_leaves)
    mask = unflatten_like(example_mask, window.mask_leaves)
    logged = window.act_leaves
    inc_act, _, _ = replay_decisions(policy, incumbent_params, obs, mask,
                                     window.stall, env_params)
    cand_act, _, _ = replay_decisions(policy, candidate_params, obs, mask,
                                      window.stall, env_params)
    inc_rows = action_agreement(inc_act, logged)
    cand_rows = action_agreement(cand_act, logged)
    n = int(inc_rows.shape[0])
    bounds = np.linspace(0, n, min(slices, n) + 1, dtype=int)
    per_slice: "list[dict]" = []
    streak = best_streak = regress = 0
    for k in range(len(bounds) - 1):
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        if hi <= lo:
            continue
        ia = float(inc_rows[lo:hi].mean())
        ca = float(cand_rows[lo:hi].mean())
        bad = ca < ia - tol
        streak = streak + 1 if bad else 0
        best_streak = max(best_streak, streak)
        regress += int(bad)
        per_slice.append({"slice": k, "rows": hi - lo,
                          "incumbent_agreement": ia,
                          "candidate_agreement": ca, "regress": bad})
    verdict = "blocked" if best_streak >= hysteresis else "promote"
    report = CanaryReport(
        verdict=verdict, rows=n, slices=len(per_slice),
        incumbent_agreement=float(inc_rows.mean()),
        candidate_agreement=float(cand_rows.mean()),
        regress_slices=regress, max_regress_streak=best_streak,
        per_slice=per_slice)
    if registry is not None:
        registry.counter(
            "flywheel_canary_runs_total",
            "canary replays executed against a candidate").inc()
        if verdict == "blocked":
            registry.counter(
                "flywheel_promotions_blocked_total",
                "candidate promotions blocked by the canary gate").inc()
    if bus is not None and verdict == "blocked":
        bus.emit("promote_blocked", rows=n,
                 incumbent_agreement=report.incumbent_agreement,
                 candidate_agreement=report.candidate_agreement,
                 max_regress_streak=best_streak)
    return report


class SLOWatchdog:
    """Live-regression tripwire for a just-promoted candidate.

    Before the swap, :meth:`sample_baseline` folds the server's
    ``serve_decision_latency_p99_ms`` gauge into an :class:`Ewma`, the
    learned baseline. :meth:`arm` snapshots the shed and recompile
    counters at the swap; each later :meth:`observe` votes *breach* when
    p99 exceeds ``P99_FACTOR`` x the baseline or new shedding appears,
    and ``breach_after`` consecutive breach votes ask for a rollback. A
    recompile after the swap asks for it at once: the swap contract says
    there must be none."""

    def __init__(self, registry, engine=None, breach_after: int = 3,
                 bus=None):
        from ..serve.batching import Ewma
        if breach_after < 1:
            raise ValueError(
                f"breach_after must be >= 1, got {breach_after}")
        self.registry = registry
        self.engine = engine          # engine or router: the recompiles
        self.breach_after = int(breach_after)
        self._bus = bus
        self._g_p99 = registry.gauge("serve_decision_latency_p99_ms")
        self._c_shed = registry.counter("serve_shed_total")
        self._ewma = Ewma(alpha=EWMA_ALPHA)
        self._streak = 0
        self._armed = False
        self._shed0 = 0.0
        self._shed_prev = 0.0
        self._rec0 = 0

    def _recompiles(self) -> int:
        if self.engine is None:
            return 0
        return int(self.engine.post_warmup_recompiles)

    @property
    def baseline_p99_ms(self) -> "float | None":
        return self._ewma.value

    def sample_baseline(self) -> None:
        """One tick before the swap: learn the incumbent's p99."""
        p99 = float(self._g_p99.value)
        if p99 > 0:
            self._ewma.update(p99)

    def arm(self) -> None:
        """Snapshot the shed and recompile counters at the swap; breach
        votes count only what accrues after."""
        self._shed0 = self._shed_prev = float(self._c_shed.value)
        self._rec0 = self._recompiles()
        self._streak = 0
        self._armed = True

    def observe(self) -> dict:
        """One tick after the swap: ``{rollback, reasons, streak, p99_ms,
        baseline_p99_ms, shed_delta, recompile_delta}``; ``rollback``
        means the caller must swap the incumbent back now."""
        if not self._armed:
            raise RuntimeError("SLOWatchdog.observe() before arm()")
        reasons = []
        rec_delta = self._recompiles() - self._rec0
        if rec_delta > 0:
            reasons.append(f"recompile(+{rec_delta})")
        p99 = float(self._g_p99.value)
        base = self._ewma.value
        if base is not None and p99 > 0 and p99 > base * P99_FACTOR:
            reasons.append(f"p99({p99:.1f}ms > {P99_FACTOR:g}x"
                           f"{base:.1f}ms)")
        shed = float(self._c_shed.value)
        if shed > self._shed_prev:
            reasons.append(f"shed(+{shed - self._shed_prev:g})")
        self._shed_prev = shed
        self._streak = self._streak + 1 if reasons else 0
        rollback = rec_delta > 0 or self._streak >= self.breach_after
        out = {"rollback": rollback, "reasons": reasons,
               "streak": self._streak, "p99_ms": p99,
               "baseline_p99_ms": base,
               "shed_delta": shed - self._shed0,
               "recompile_delta": rec_delta}
        if rollback and self._bus is not None:
            self._bus.emit("promote_rollback", reasons=reasons,
                           streak=self._streak, p99_ms=p99,
                           baseline_p99_ms=base)
        return out


class PromotionLedger:
    """Crash-safe JSONL lineage of every promotion decision.

    An append is written and flushed (and fsynced when ``durable``), then
    the sidecar ``.crc/promotions.json`` (``{"bytes": N, "crc32": C}``
    over the sealed prefix) is rewritten atomically. A crash between the
    two leaves entries past the sealed prefix, which :func:`read_ledger`
    returns apart as the unsealed tail; a prefix that fails its crc
    raises :class:`LedgerCorruptError`."""

    def __init__(self, directory: str, durable: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(os.path.join(self.directory, ".crc"), exist_ok=True)
        self.path = os.path.join(self.directory, LEDGER_NAME)
        self.durable = bool(durable)
        self._lock = threading.Lock()

    @property
    def _sidecar(self) -> str:
        return os.path.join(self.directory, ".crc", "promotions.json")

    def append(self, record: dict) -> None:
        """Append one decision record (a JSON-able dict; its ``action``
        or ``event`` key names the decision)."""
        line = json.dumps(record, sort_keys=True) + "\n"
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line)
                f.flush()
                if self.durable:
                    os.fsync(f.fileno())
            crc = _crc32_file(self.path)
            size = os.path.getsize(self.path)
            tmp = f"{self._sidecar}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"bytes": size, "crc32": crc}, f)
                f.flush()
                if self.durable:
                    os.fsync(f.fileno())
            os.replace(tmp, self._sidecar)


def read_ledger(directory: str) -> "tuple[list[dict], list[dict]]":
    """A promotion ledger as ``(sealed, tail)``: the sealed entries are
    crc-verified against the sidecar; the tail entries (appended after
    the last sidecar update) parse but are flagged by position, and a
    torn last line is skipped. A missing ledger is ``([], [])``."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, LEDGER_NAME)
    side = os.path.join(directory, ".crc", "promotions.json")
    if not os.path.exists(path):
        return [], []
    with open(path, "rb") as f:
        blob = f.read()
    sealed_bytes = 0
    if os.path.exists(side):
        with open(side) as f:
            meta = json.load(f)
        sealed_bytes = int(meta["bytes"])
        if zlib.crc32(blob[:sealed_bytes]) != int(meta["crc32"]):
            raise LedgerCorruptError(
                f"{path}: sealed prefix ({sealed_bytes} bytes) fails its "
                f"crc sidecar; the lineage cannot be trusted")
    sealed = [json.loads(l) for l in blob[:sealed_bytes].decode()
              .splitlines() if l.strip()]
    tail = []
    for l in blob[sealed_bytes:].decode(errors="replace").splitlines():
        try:
            tail.append(json.loads(l))
        except json.JSONDecodeError:
            pass                     # a torn final line
    return sealed, tail
