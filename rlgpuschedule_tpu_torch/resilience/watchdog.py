"""Divergence watchdog of the port.

Counterpart of the JAX package's ``resilience/watchdog.py``, with its
reason strings, stderr line and ``rollback`` bus event. A NaN in one
update silently poisons every later iteration: the run keeps training
on garbage until someone reads the curves. The watchdog checks each
iteration's metrics (read in the one host transfer the loop already
makes when it logs) and, on divergence, rolls the experiment back to
the last good checkpoint with a decayed learning rate; after
``max_rollbacks`` it gives up with a clean :class:`DivergenceError`
instead of looping for ever.

Determinism: the decay is ``lr_decay ** n_rollbacks`` and the retry's
generators are reseeded from their restored states and
``n_rollbacks`` (``Experiment.fold_key``), so a faulted run recovers the
same way every time it is replayed, on a stream other than the one that
diverged.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Any


class DivergenceError(RuntimeError):
    """The run diverged more times than ``max_rollbacks`` allows."""


@dataclasses.dataclass
class RollbackEvent:
    """One recovery action, as it appears in the run summary and log."""
    iteration: int           # iteration whose metrics tripped the check
    restored_step: int | None  # checkpoint step actually restored
    resume_iteration: int    # iteration training resumes from
    n_rollback: int          # 1-based rollback counter
    lr_scale: float          # LR multiplier now in effect
    reason: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class DivergenceWatchdog:
    """Per-iteration divergence detection and checkpoint rollback.

    >>> wd = DivergenceWatchdog(max_rollbacks=3)
    >>> out = exp.run(..., ckpt=ckpt, ckpt_every=10, watchdog=wd)

    ``check`` flags (a) any non-finite metric and (b) a ``total_loss``
    whose magnitude exceeds ``blowup_factor`` x the running loss EMA,
    the finite-but-exploding precursor a plain NaN check misses. The EMA
    resets on rollback, so the retried trajectory is judged afresh.
    """

    def __init__(self, max_rollbacks: int = 3, lr_decay: float = 0.5,
                 blowup_factor: float = 1e4, ema_decay: float = 0.9,
                 bus=None):
        if max_rollbacks < 0:
            raise ValueError(f"max_rollbacks must be >= 0, "
                             f"got {max_rollbacks}")
        self.max_rollbacks = max_rollbacks
        self.lr_decay = lr_decay
        self.blowup_factor = blowup_factor
        self.ema_decay = ema_decay
        self.n_rollbacks = 0
        self.events: list[RollbackEvent] = []
        self._loss_ema: float | None = None
        self._bus = bus   # obs.EventBus (or None): the rollback timeline

    def check(self, metrics: dict[str, float]) -> str | None:
        """Reason string if this iteration's metrics look divergent, else
        None (and the loss EMA advances)."""
        for k, v in metrics.items():
            if not math.isfinite(v):
                return f"non-finite {k}={v}"
        loss = metrics.get("total_loss")
        if loss is not None:
            if self._loss_ema is not None and \
                    abs(loss) > self.blowup_factor * max(
                        abs(self._loss_ema), 1.0):
                return (f"loss blow-up: |total_loss|={abs(loss):.3g} > "
                        f"{self.blowup_factor:g} x ema "
                        f"{abs(self._loss_ema):.3g}")
            self._loss_ema = (loss if self._loss_ema is None else
                              self.ema_decay * self._loss_ema
                              + (1 - self.ema_decay) * loss)
        return None

    def check_population(self, fitness: Any) -> str | None:
        """Population variant: a SINGLE dead member is PBT's job (the
        exploit re-seeds it from the best member); the watchdog rolls
        back only the catastrophic case where NO member has finite
        fitness, with nobody left to re-seed from. ``fitness`` (a tensor
        on any device, an array or a list) is read in one host
        transfer."""
        raw = fitness.tolist() if hasattr(fitness, "tolist") else fitness
        vals = [float(v) for v in raw]
        if vals and not any(math.isfinite(v) for v in vals):
            return f"all {len(vals)} members non-finite (fitness={vals})"
        return None

    def rollback(self, exp: Any, ckpt: Any, iteration: int,
                 reason: str) -> RollbackEvent:
        """Roll ``exp`` back to the last good checkpoint (the integrity
        fallback included: a corrupted latest step falls through to the
        previous retained one), decay the LR, move the generators to the
        retry's stream, and return the event. Raises
        :class:`DivergenceError` once ``max_rollbacks`` is exhausted."""
        if self.n_rollbacks >= self.max_rollbacks:
            raise DivergenceError(
                f"diverged at iteration {iteration} ({reason}) after "
                f"{self.n_rollbacks} rollback(s); max_rollbacks="
                f"{self.max_rollbacks} exhausted — giving up cleanly")
        self.n_rollbacks += 1
        # settle the store first: rolling back past a save still being
        # finalized would silently lose good iterations
        ckpt.wait()
        meta = exp.restore_checkpoint(ckpt)
        scale = self.lr_decay ** self.n_rollbacks
        exp.scale_lr(scale)
        exp.fold_key(self.n_rollbacks)
        resume = int((meta or {}).get("iteration", -1)) + 1
        self._loss_ema = None
        event = RollbackEvent(
            iteration=iteration, restored_step=ckpt.last_restored_step,
            resume_iteration=resume, n_rollback=self.n_rollbacks,
            lr_scale=scale, reason=reason)
        self.events.append(event)
        if self._bus is not None:
            self._bus.emit("rollback", **event.as_dict())
        print(f"watchdog: {reason} at iteration {iteration} -> rolled "
              f"back to checkpoint step {event.restored_step} (resume "
              f"iteration {resume}, lr x{scale:g}, rollback "
              f"{self.n_rollbacks}/{self.max_rollbacks})",
              file=sys.stderr, flush=True)
        return event
