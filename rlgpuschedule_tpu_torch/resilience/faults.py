"""Deterministic fault injection of the port.

Counterpart of the JAX package's ``resilience/faults.py``, with its
spec grammar, exit codes, error texts, stderr lines and ``fault`` bus
events. Faults are fully specified by their spec string (no RNG), so a
faulted run is exactly reproducible and every recovery path can be
asserted in CPU tests. The kinds, one per recovery path:

- ``nan-grad@K`` -- at training iteration K, poison the parameters with
  NaN and flag the iteration's ``total_loss`` non-finite, as if one
  update had applied a NaN gradient. Recovery: the
  :class:`~.watchdog.DivergenceWatchdog` rolls back to the last good
  checkpoint. Against a PBT population, ``:rank=M`` selects which member
  is poisoned (default 0); recovery is then the exploit re-seed of the
  dead member (``parallel.pbt.exploit_explore``). K counts iterations
  over the experiment's life, as the port's cadences do (JAX counts from
  the ``run`` call's first; the two agree on a fresh build).
- ``corrupt-ckpt@K`` -- truncate the payload of the checkpoint written
  after iteration K, right after its save. Recovery: the integrity
  fallback of ``Checkpointer.restore`` to the previous retained step.
- ``kill-rank@T[:rank=R]`` / ``lose-rank@T[:rank=R]`` -- multihost: rank
  R exits before train step T with :data:`KILL_RANK_EXIT` (restartable)
  or :data:`LOSE_RANK_EXIT` (permanently lost). The train CLI refuses
  them; the multihost worker that arms them is the data-parallel slice's
  (``ROADMAP.md`` queue 1, item 21).

Each fault fires exactly once: a rollback that replays iteration K must
not trip the same fault again, or no retry could succeed.

Nothing here imports torch at module level; the hooks that touch
tensors import it when they fire.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any

FAULT_KINDS = ("nan-grad", "corrupt-ckpt", "kill-rank", "lose-rank")

# exit codes a supervised gang's ranks die with; the supervisor keys its
# restart decision on them (same-size restart against shrink-to-fit)
KILL_RANK_EXIT = 17   # restartable death: respawn at the same world size
LOSE_RANK_EXIT = 23   # permanent loss: relaunch at the surviving world size


@dataclasses.dataclass
class FaultSpec:
    kind: str       # one of FAULT_KINDS
    at: int         # iteration (nan-grad/corrupt-ckpt) or train step (kill)
    rank: int = 0   # kill-rank: process rank; nan-grad vs PBT: member index
    fired: bool = False


def parse_fault(spec: str) -> FaultSpec:
    """Parse ``kind@N[:rank=R]`` (e.g. ``nan-grad@3``,
    ``kill-rank@2:rank=1``). Raises ValueError with the offending spec."""
    body = spec.strip()
    rank = 0
    if ":" in body:
        body, _, opt = body.partition(":")
        key, _, val = opt.partition("=")
        if key.strip() != "rank" or not val.strip().lstrip("-").isdigit():
            raise ValueError(f"bad fault option {opt!r} in {spec!r} "
                             f"(expected rank=R)")
        rank = int(val)
    kind, sep, at = body.partition("@")
    kind = kind.strip()
    if kind not in FAULT_KINDS or not sep or not at.strip().isdigit():
        raise ValueError(
            f"bad fault spec {spec!r}; expected kind@N[:rank=R] with kind "
            f"in {FAULT_KINDS}")
    return FaultSpec(kind=kind, at=int(at), rank=rank)


def corrupt_checkpoint(directory: str, step: int,
                       fix_checksums: bool = False) -> int:
    """Truncate the payload of checkpoint ``step`` under ``directory``
    (``<step>/state.pt``) to half its size, the truncated-save failure
    mode. Returns the number of files corrupted; raises
    ``FileNotFoundError`` if the step has no payload (corrupting nothing
    would silently test nothing).

    ``fix_checksums=True`` rewrites the step's crc32 sidecar after the
    corruption, so the cheap checksum pre-check passes and the failed
    load is what the fallback has to catch."""
    from ..checkpoint import STATE_FILE, write_checksum_sidecar
    step_dir = os.path.join(directory, str(step))
    targets = [f for f in (os.path.join(step_dir, STATE_FILE),)
               if os.path.isfile(f)]
    if not targets:
        raise FileNotFoundError(
            f"no checkpoint data files under {step_dir} to corrupt")
    for f in targets:
        with open(f, "r+b") as fh:
            fh.truncate(max(os.path.getsize(f) // 2, 1))
    if fix_checksums:
        write_checksum_sidecar(directory, step)
    return len(targets)


class FaultInjector:
    """Host-side injection hooks called from the training loops. Holds the
    parsed specs; every hook is a no-op unless a spec not yet fired
    matches the current iteration or step, so an attached injector costs
    nothing on the healthy path."""

    def __init__(self, specs: list[FaultSpec], bus=None):
        self.specs = list(specs)
        self._bus = bus   # obs.EventBus (or None): fault firings

    def _emit(self, spec: FaultSpec, **fields: Any) -> None:
        if self._bus is not None:
            self._bus.emit("fault", fault=spec.kind, at=spec.at,
                           target_rank=spec.rank, **fields)

    def _take(self, kind: str, at: int) -> FaultSpec | None:
        for s in self.specs:
            if s.kind == kind and s.at == at and not s.fired:
                s.fired = True
                return s
        return None

    def poison_nan(self, exp: Any, iteration: int, metrics: Any) -> Any:
        """``nan-grad`` hook (single-run ``Experiment``): multiply every
        parameter by NaN in place and make the iteration's ``total_loss``
        NaN, on the device, with no host read. Returns the (possibly
        poisoned) metrics NamedTuple."""
        spec = self._take("nan-grad", iteration)
        if spec is None:
            return metrics
        import torch
        self._emit(spec, iteration=iteration)
        print(f"fault-injection: nan-grad at iteration {iteration} "
              f"(params poisoned)", file=sys.stderr, flush=True)
        with torch.no_grad():
            for p in exp.net.parameters():
                p.mul_(float("nan"))
        return metrics._replace(
            total_loss=metrics.total_loss * float("nan"))

    def poison_nan_member(self, pop: Any, iteration: int,
                          metrics: Any) -> Any:
        """``nan-grad`` hook (``PopulationExperiment``): set ONE member's
        parameters (spec ``rank`` = member index) and its ``mean_reward``
        entry to NaN, the dead-member input to the PBT exploit re-seed."""
        spec = self._take("nan-grad", iteration)
        if spec is None:
            return metrics
        import torch
        m = spec.rank
        self._emit(spec, iteration=iteration, member=m)
        print(f"fault-injection: nan-grad at iteration {iteration} "
              f"member {m}", file=sys.stderr, flush=True)
        with torch.no_grad():
            for p in pop.members[m].net.parameters():
                p.fill_(float("nan"))
        reward = metrics.mean_reward.clone()
        reward[m] = float("nan")
        return metrics._replace(mean_reward=reward)

    def corrupt_after_save(self, ckpt: Any, iteration: int) -> None:
        """``corrupt-ckpt`` hook: right after the periodic save at
        ``iteration``, corrupt the just-saved (latest) step's payload."""
        spec = self._take("corrupt-ckpt", iteration)
        if spec is None:
            return
        ckpt.wait()          # the save must be on disk to corrupt
        step = ckpt.latest_step()
        n = corrupt_checkpoint(ckpt.directory, step)
        self._emit(spec, iteration=iteration, step=step, files=n)
        print(f"fault-injection: corrupted checkpoint step {step} "
              f"({n} files) after iteration {iteration}",
              file=sys.stderr, flush=True)

    def maybe_exit_rank(self, rank: int, step: int) -> None:
        """``kill-rank`` / ``lose-rank`` hook (a multihost worker): rank
        ``rank`` dies ungracefully right before train step ``step``,
        exiting :data:`KILL_RANK_EXIT` (restartable) or
        :data:`LOSE_RANK_EXIT` (permanent loss: the supervisor shrinks
        the gang instead of respawning rank R)."""
        for s in self.specs:
            if s.kind in ("kill-rank", "lose-rank") and s.at == step \
                    and s.rank == rank and not s.fired:
                s.fired = True
                code = (KILL_RANK_EXIT if s.kind == "kill-rank"
                        else LOSE_RANK_EXIT)
                # the bus appends and flushes per emit, so the event is
                # durable before the ungraceful exit below
                self._emit(s, step=step, exit_code=code)
                print(f"fault-injection: rank {rank} dying before step "
                      f"{step} ({s.kind}, exit {code})",
                      file=sys.stderr, flush=True)
                os._exit(code)

    # JAX's older name of the same hook
    maybe_kill_rank = maybe_exit_rank
