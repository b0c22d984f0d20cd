"""Declarative SLOs evaluated as multi-window burn rates.

The port's copy of the JAX package's ``obs/slo.py`` (pure Python).

``slo_snapshot()`` answered "what are the percentiles right now" and
only when someone remembered to call it. This module makes "are we
meeting the SLO" a first-class, alarm-wired answer: an
:class:`SLOSpec` declares an objective (a target success fraction —
availability = 1 − shed/fail rate, or a latency target expressed as the
fraction of requests under a bound), and the :class:`SLOEngine`
evaluates it continuously as **burn rates** over several sliding
windows of a cumulative ``(bad, total)`` event stream.

Burn rate is the SRE workbook quantity: the windowed error rate divided
by the error budget (``1 − objective``). Burn 1.0 spends exactly the
budget over the window; burn 14 torches it. Evaluating the same SLI
over a short AND a long window makes the alert both fast-firing and
fast-clearing: the alert condition requires **every** window of the
spec to exceed its threshold, so a transient spike trips it quickly
(all windows saturate together) and the short window un-trips it
quickly once the bleeding stops.

Surfaces, all refreshed by a :meth:`Registry.collect` pre-scrape
collector hook (never stale — registration wires the engine into every
``render()``):

- ``slo_burn_rate{slo=...,window=...}`` — per-window burn gauges;
- ``slo_error_budget_remaining{slo=...}`` — rolling error budget over
  the spec's budget window, in [0, 1]; it RECOVERS as the window
  slides past an incident (this is deliberately not the calendar-
  period budget: a serving rig wants "are we still bleeding", not
  "how was the quarter");
- ``slo_burn_alerts_total{slo=...}`` — alert edge counter;
- bus events ``slo_burn_alert`` (rising edge, carries the per-window
  burns) and ``slo_burn_clear`` (falling edge, carries the recovered
  budget) — neither is an alarm kind, so ``--strict-alarms`` stays a
  compile/transfer contract while SLO health gets its own channel.

The engine never reads metrics by name: each spec is registered with a
``sample()`` callable returning the cumulative ``(bad, total)`` pair,
so any counter arithmetic (shed + dispatch errors + retry hedges) or
histogram tail (:func:`histogram_sli`) can be an SLI without the
engine knowing the serving layer's metric names.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

from .metrics import Histogram, Registry

# the default multi-window ladder (scaled-down SRE workbook shape):
# (window_seconds, burn threshold) — every window must exceed its
# threshold for the spec to alert
DEFAULT_WINDOWS = ((60.0, 14.4), (300.0, 6.0), (3600.0, 1.0))


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective.

    ``objective`` is the target success fraction (0.999 availability =
    "at most 1 in 1000 requests shed or failed"); for a latency SLO the
    *SLI itself* encodes the latency target (bad = requests over the
    bound) and ``objective`` is the fraction required under it.
    ``windows`` is the multi-window burn ladder; ``budget_window_s``
    (default: the longest window) is the sliding window the
    error-budget gauge is computed over.
    """

    name: str
    objective: float
    windows: "tuple[tuple[float, float], ...]" = DEFAULT_WINDOWS
    budget_window_s: "float | None" = None
    description: str = ""

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"slo {self.name!r}: objective must be in "
                             f"(0, 1), got {self.objective}")
        if not self.windows:
            raise ValueError(f"slo {self.name!r}: need >= 1 window")
        for w, thresh in self.windows:
            if w <= 0 or thresh <= 0:
                raise ValueError(f"slo {self.name!r}: bad window "
                                 f"({w}, {thresh})")
        if self.budget_window_s is not None and self.budget_window_s <= 0:
            raise ValueError(f"slo {self.name!r}: budget_window_s must "
                             f"be positive")

    @property
    def budget_window(self) -> float:
        if self.budget_window_s is not None:
            return self.budget_window_s
        return max(w for w, _ in self.windows)


def histogram_sli(hist: Histogram, target_s: float) -> Callable:
    """SLI over a fixed-bucket :class:`Histogram`: bad = observations
    in buckets strictly above the largest bucket bound <= ``target_s``
    (conservative — a target between bounds counts the straddling
    bucket as bad), total = all observations."""
    bounds = [le for le in hist.buckets if le <= float(target_s)]
    if not bounds:
        raise ValueError(f"latency target {target_s}s is below the "
                         f"lowest bucket bound {hist.buckets[0]}s")
    le = bounds[-1]

    def sample() -> "tuple[float, float]":
        good = 0
        for b, acc in hist.cumulative():
            if b == le:
                good = acc
                break
        return float(hist.count - good), float(hist.count)

    return sample


class _Watch:
    __slots__ = ("spec", "sample", "samples", "alerting",
                 "g_burn", "g_budget", "c_alerts")

    def __init__(self, spec, sample, registry):
        self.spec = spec
        self.sample = sample
        # (t, bad, total) cumulative samples, pruned past the horizon
        self.samples: deque = deque()
        self.alerting = False
        self.g_burn = {
            w: registry.gauge(
                "slo_burn_rate",
                "windowed error rate over the error budget, per SLO "
                "window (1.0 = spending exactly the budget)",
                labels={"slo": spec.name, "window": f"{w:g}s"})
            for w, _ in spec.windows}
        self.g_budget = registry.gauge(
            "slo_error_budget_remaining",
            "rolling error budget left over the SLO's budget window, "
            "in [0, 1] (recovers as the window slides past an incident)",
            labels={"slo": spec.name})
        self.c_alerts = registry.counter(
            "slo_burn_alerts_total",
            "burn-rate alert rising edges per SLO",
            labels={"slo": spec.name})


class SLOEngine:
    """Evaluates registered :class:`SLOSpec` s on every ``collect()``.

    Construction registers the engine as a pre-scrape collector on the
    registry, so every ``render()`` (file snapshot, HTTP scrape) gets
    freshly computed burn/budget gauges; ``close()`` deregisters it.
    ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, registry: Registry, bus=None, clock=None):
        self._registry = registry
        self._bus = bus
        self._clock = clock if clock is not None else time.monotonic
        self._watches: "list[_Watch]" = []
        registry.add_collector(self.collect)

    def watch(self, spec: SLOSpec, sample: Callable) -> SLOSpec:
        """Register ``spec`` over ``sample() -> (bad, total)`` (both
        cumulative, monotone non-decreasing). Returns the spec for
        chaining."""
        if any(w.spec.name == spec.name for w in self._watches):
            raise ValueError(f"slo {spec.name!r} already watched")
        self._watches.append(_Watch(spec, sample, self._registry))
        return spec

    def _delta(self, watch: _Watch, now: float,
               window: float) -> "tuple[float, float]":
        """(bad, total) accumulated over the trailing ``window``:
        current sample minus the newest sample at or before the window
        start (the oldest retained sample when history is shorter)."""
        t, bad, total = watch.samples[-1]
        base = watch.samples[0]
        for s in watch.samples:
            if s[0] <= now - window:
                base = s
            else:
                break
        return bad - base[1], total - base[2]

    def collect(self) -> None:
        now = self._clock()
        for watch in self._watches:
            spec = watch.spec
            bad, total = watch.sample()
            watch.samples.append((now, float(bad), float(total)))
            horizon = max(spec.budget_window,
                          max(w for w, _ in spec.windows))
            while len(watch.samples) > 2 \
                    and watch.samples[1][0] <= now - horizon:
                watch.samples.popleft()
            budget_frac = 1.0 - spec.objective
            burns = {}
            alerting = True
            for w, thresh in spec.windows:
                db, dt = self._delta(watch, now, w)
                err = (db / dt) if dt > 0 else 0.0
                burn = err / budget_frac
                burns[w] = burn
                watch.g_burn[w].set(burn)
                if not (dt > 0 and burn >= thresh):
                    alerting = False
            db, dt = self._delta(watch, now, spec.budget_window)
            spent = (db / (dt * budget_frac)) if dt > 0 else 0.0
            budget = min(1.0, max(0.0, 1.0 - spent))
            watch.g_budget.set(budget)
            if alerting and not watch.alerting:
                watch.c_alerts.inc()
                if self._bus is not None:
                    self._bus.emit(
                        "slo_burn_alert", slo=spec.name,
                        objective=spec.objective,
                        burns={f"{w:g}s": round(b, 3)
                               for w, b in burns.items()},
                        budget_remaining=budget)
            elif watch.alerting and not alerting:
                if self._bus is not None:
                    self._bus.emit("slo_burn_clear", slo=spec.name,
                                   budget_remaining=budget)
            watch.alerting = alerting

    def status(self) -> "dict[str, dict]":
        """Point-in-time view per spec (after the last collect)."""
        out = {}
        for watch in self._watches:
            out[watch.spec.name] = {
                "alerting": watch.alerting,
                "budget_remaining": watch.g_budget.value,
                "budget_window_s": watch.spec.budget_window,
                "burn": {f"{w:g}s": g.value
                         for w, g in watch.g_burn.items()},
                "alerts_total": watch.c_alerts.value,
            }
        return out

    def close(self) -> None:
        self._registry.remove_collector(self.collect)
