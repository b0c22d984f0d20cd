"""Clock-skew handshake: one corrected time axis for cross-host merges.

The port's copy of the JAX package's ``obs/skew.py`` (pure Python).
``merge_dir`` orders events by ``mono`` (CLOCK_MONOTONIC), which is
correct on ONE host -- every process shares the boot-relative clock --
but each host's monotonic epoch is its own boot time, so a multi-host
merge interleaves incomparable axes.

The handshake: every event the bus stamps already carries BOTH clocks
``(wall, mono)`` read back to back, so every event is an offset sample
of ``wall - mono`` for its rank. Ranks also stamp explicit
``clock_skew`` events (:func:`stamp`) at worker start and each
heartbeat, so the offset is sampled across the run's whole life even on
ranks that emit little else. :func:`learn_offsets` takes the median
``wall - mono`` per rank (the median rejects NTP steps and scheduling
outliers); :func:`correct_events` rewrites each event's ``mono`` onto
the reference rank's axis by the learned offset *delta*, re-sorts, and
annotates the shift and the residual uncertainty (the per-rank sample
spread: wall-clock sync error between hosts cannot be observed from
inside, so the spread is the honest error bar).

On a single host the learned offsets agree to microseconds, so the
correction is close to a no-op.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Iterable

from .events import EventBus, merge_dir, merge_events

# the dedicated offset-sample event kind (worker start + heartbeats)
CLOCK_SKEW = "clock_skew"


def stamp(bus: EventBus, source: str = "heartbeat",
          **fields: Any) -> dict:
    """Emit one explicit offset sample: the bus's own ``(wall, mono)``
    stamp pair IS the measurement (read back-to-back in ``emit``), so
    the event needs no payload beyond provenance."""
    return bus.emit(CLOCK_SKEW, source=source, **fields)


@dataclasses.dataclass
class RankSkew:
    """One rank's learned clock offset: ``offset_s`` is the median
    ``wall - mono``; ``residual_s`` the sample spread (max - min) —
    the uncertainty left after correction."""

    rank: int
    offset_s: float
    residual_s: float
    n_samples: int
    dedicated: bool     # from clock_skew events (vs all-event fallback)


def learn_offsets(events: Iterable[dict]) -> dict[int, RankSkew]:
    """Per-rank offset estimates. Dedicated ``clock_skew`` samples are
    preferred; a rank that never stamped one falls back to the implicit
    samples every bus event carries."""
    dedicated: dict[int, list[float]] = {}
    implicit: dict[int, list[float]] = {}
    for e in events:
        if "mono" not in e or "wall" not in e:
            continue
        rank = int(e.get("rank", 0))
        sample = float(e["wall"]) - float(e["mono"])
        implicit.setdefault(rank, []).append(sample)
        if e.get("kind") == CLOCK_SKEW:
            dedicated.setdefault(rank, []).append(sample)
    out: dict[int, RankSkew] = {}
    for rank, fallback in implicit.items():
        samples = dedicated.get(rank, fallback)
        out[rank] = RankSkew(
            rank=rank,
            offset_s=statistics.median(samples),
            residual_s=(max(samples) - min(samples)),
            n_samples=len(samples),
            dedicated=rank in dedicated)
    return out


def correct_events(events: list[dict],
                   skews: dict[int, RankSkew] | None = None,
                   reference_rank: int | None = None,
                   ) -> tuple[list[dict], dict]:
    """Rewrite a merged timeline onto one corrected ``mono`` axis.

    Each rank's events shift by ``offset_rank - offset_reference`` (the
    reference defaults to the lowest non-negative rank, so rank 0's
    axis is the run's axis). Shifted events keep the raw stamp as
    ``mono_raw`` and carry ``skew_shift_s``. Returns the re-sorted
    timeline plus an info dict (``applied``, per-rank offsets/shifts/
    residuals, ``max_residual_s``). With fewer than two ranks sampled
    the correction is an honest no-op (``applied: False``) — there is
    nothing to align."""
    if skews is None:
        skews = learn_offsets(events)
    info: dict = {"applied": False, "reference_rank": None, "ranks": {}}
    if len(skews) < 2:
        return list(events), info
    if reference_rank is None:
        nonneg = [r for r in skews if r >= 0]
        reference_rank = min(nonneg) if nonneg else min(skews)
    elif reference_rank not in skews:
        raise ValueError(f"reference rank {reference_rank} has no "
                         f"offset samples (ranks: {sorted(skews)})")
    ref = skews[reference_rank].offset_s
    out = []
    for e in events:
        rank = int(e.get("rank", 0))
        sk = skews.get(rank)
        shift = (sk.offset_s - ref) if sk is not None else 0.0
        if "mono" in e and shift != 0.0:
            e = dict(e, mono=e["mono"] + shift, mono_raw=e["mono"],
                     skew_shift_s=round(shift, 9))
        out.append(e)
    info = {
        "applied": True,
        "reference_rank": reference_rank,
        "max_residual_s": round(max(s.residual_s
                                    for s in skews.values()), 9),
        "ranks": {str(r): {"offset_s": round(s.offset_s, 9),
                           "shift_s": round(s.offset_s - ref, 9),
                           "residual_s": round(s.residual_s, 9),
                           "n_samples": s.n_samples,
                           "dedicated": s.dedicated}
                  for r, s in sorted(skews.items())},
    }
    return merge_events(out), info


def merge_dir_corrected(directory: str) -> tuple[list[dict], dict]:
    """:func:`.events.merge_dir`, then learn per-rank offsets and
    rewrite the merged timeline onto the corrected axis."""
    return correct_events(merge_dir(directory))
