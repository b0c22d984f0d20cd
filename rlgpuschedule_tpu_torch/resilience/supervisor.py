"""Elastic gang supervision of the port: the detect -> decide -> relaunch
loop, with no process launcher of its own.

Counterpart of the JAX package's ``resilience/supervisor.py`` less its
``SubprocessGang`` and ``SubprocessGangLauncher``, which start the
multihost worker and come with the data-parallel slice (``ROADMAP.md``
queue 1, item 21). Plain Python with the same decisions, budget
arithmetic, jitter stream, log lines and bus events as JAX's, so the
same launcher gives the same :class:`SupervisorResult` under either
package. The pieces:

- :class:`Launcher` -- how a gang starts and where its durable progress
  lives; the supervisor calls nothing else of it. A subprocess gang is
  one launcher, a pod launcher another.
- :class:`RestartPolicy` -- exponential backoff with seeded jitter, a
  ``max_restarts`` budget and a restart-storm guard: a failure within
  the backoff window of the previous one (the gang died about as fast
  as it came up) charges double, so a crash-looping gang stops early
  instead of burning the whole budget at full speed.
- :class:`Supervisor` -- owns the loop. Detection is exit codes (the
  fast signal) and heartbeat staleness (the general one: a dead rank
  leaves its peers blocked in a collective). A rank that exits with a
  code in ``permanent_exit_codes`` (``faults.LOSE_RANK_EXIT``) is lost
  for good: the gang relaunches shrunk to the surviving world size,
  each new rank restoring a surviving old rank's checkpoint; any other
  death restarts at the same size from the gang-wide minimum completed
  step. It ends in a :class:`SupervisorResult` that says why:
  ``completed``, or ``gave_up`` with the budget or floor reason.

The supervisor sees processes, exit codes, heartbeat files and
checkpoint steps, never a tensor: what a production pod supervisor sees.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Sequence

from .faults import LOSE_RANK_EXIT
from .heartbeat import HeartbeatMonitor


class SupervisorTimeout(RuntimeError):
    """The overall deadline elapsed with a gang still running (a hang the
    heartbeat timeout did not attribute to any single rank)."""


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One (re)launch decision. ``restore_ranks`` maps each NEW rank i to
    the OLD rank whose checkpoint it restores (shrink-to-fit: new rank i
    resumes from ``restore_ranks[i]``'s files); ``None`` means identity
    (every rank restores its own)."""
    world_size: int
    attempt: int = 0                       # 0 = first launch
    resume_step: int | None = None         # None = fresh start
    restore_ranks: tuple[int, ...] | None = None


@dataclasses.dataclass
class SupervisorEvent:
    """One detected failure and what it cost."""
    attempt: int
    world_size: int
    rank: int
    detected_by: str       # "exit=N" | "heartbeat>Ts"
    permanent: bool
    charge: int            # 1, or 2 when the storm guard doubled it


@dataclasses.dataclass
class SupervisorResult:
    """Terminal state of a supervised run. ``outcome`` is ``"completed"``
    or ``"gave_up"``; ``reason`` says why a run gave up (budget
    exhausted, world floor) and is ``None`` on success."""
    outcome: str
    reason: str | None
    restarts: int
    world_size: int
    resume_step: int | None
    detected_by: str | None
    outputs: list[str]
    events: list[SupervisorEvent]
    budget_spent: int
    storm_charges: int

    @property
    def shrunk(self) -> bool:
        return any(e.permanent for e in self.events)


class Gang:
    """A launched gang. ``poll()`` returns one exit code per rank (None =
    still running); ``kill()`` tears every rank down; ``outputs()``
    returns each rank's captured output."""

    def poll(self) -> list[int | None]:
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError

    def outputs(self) -> list[str]:
        raise NotImplementedError

    def tails(self, n: int = 500) -> list[str]:
        return [out[-n:] for out in self.outputs()]


class Launcher:
    """How gangs start and where their durable progress lives. The
    supervisor calls only :meth:`launch` and :meth:`completed_steps`."""

    world_size: int   # the initial (full) world size

    def launch(self, plan: LaunchPlan) -> Gang:
        raise NotImplementedError

    def completed_steps(self, ranks: Sequence[int]) -> dict[int, int]:
        """``{rank: last durably completed step}`` for the ranks that
        have one; a rank with no durable checkpoint is absent."""
        raise NotImplementedError


class RestartPolicy:
    """Restart budget, exponential backoff, seeded jitter and the
    restart-storm guard.

    A failure is stormy when it lands within ``storm_window_s`` of the
    previous one (default: the backoff delay just applied plus one base
    backoff) and charges 2 against ``max_restarts`` instead of 1.
    ``exhausted()`` is true once the charges EXCEED ``max_restarts`` (a
    budget of N allows N healthy restarts).

    The jitter comes from ``random.Random(jitter_seed)``, JAX's stream,
    so a supervised run is reproducible and its delays are JAX's;
    distinct supervisors should get distinct seeds (decorrelating
    relaunches is the point of jitter)."""

    def __init__(self, max_restarts: int, backoff_s: float = 1.0,
                 backoff_max_s: float = 30.0, jitter_frac: float = 0.25,
                 jitter_seed: int = 0,
                 storm_window_s: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.jitter_frac = jitter_frac
        self.storm_window_s = storm_window_s
        self._rng = random.Random(jitter_seed)
        self._clock = clock
        self.failures = 0          # failures observed
        self.spent = 0             # budget charges (>= failures)
        self.storm_charges = 0     # failures that were charged double
        self._last_failure_t: float | None = None
        self._last_delay = 0.0

    def record_failure(self) -> int:
        """Account one detected failure; returns the charge (1 or 2)."""
        now = self._clock()
        window = (self.storm_window_s if self.storm_window_s is not None
                  else self._last_delay + self.backoff_s)
        charge = 1
        if (self._last_failure_t is not None
                and now - self._last_failure_t <= window):
            charge = 2
            self.storm_charges += 1
        self.failures += 1
        self.spent += charge
        self._last_failure_t = now
        return charge

    def exhausted(self) -> bool:
        return self.spent > self.max_restarts

    def next_delay(self) -> float:
        """Backoff before the next relaunch: exponential in the failure
        count, capped, stretched upwards by up to ``jitter_frac``."""
        base = min(self.backoff_s * 2 ** max(self.failures - 1, 0),
                   self.backoff_max_s)
        self._last_delay = base * (1.0 + self.jitter_frac
                                   * self._rng.random())
        return self._last_delay


@dataclasses.dataclass
class _Failure:
    rank: int
    detected_by: str
    permanent: bool


class Supervisor:
    """Drives one supervised run to a terminal state (the module
    docstring has the loop). ``monitor_factory(world_size)`` builds the
    heartbeat monitor of each (re)launch (a fresh monitor is a fresh
    grace window at the current world size), or ``None`` for detection
    by exit codes only. ``sleep`` and ``clock`` are injectable, as the
    tests inject them."""

    def __init__(self, launcher: Launcher, policy: RestartPolicy, *,
                 monitor_factory: Callable[[int], HeartbeatMonitor]
                 | None = None,
                 min_world: int = 1,
                 permanent_exit_codes: tuple[int, ...] = (LOSE_RANK_EXIT,),
                 deadline_s: float = 900.0, poll_interval_s: float = 0.2,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 log: Callable[[str], None] | None = None, bus=None):
        self.launcher = launcher
        self.policy = policy
        self.monitor_factory = monitor_factory
        self.min_world = min_world
        self.permanent_exit_codes = tuple(permanent_exit_codes)
        self.deadline_s = deadline_s
        self.poll_interval_s = poll_interval_s
        self._sleep = sleep
        self._clock = clock
        self._log = log or (lambda msg: print(msg, flush=True))
        # obs.EventBus (or None): each detect -> decide -> relaunch step
        # lands on the run's timeline, so the post-mortem tells the story
        # SupervisorResult sums up
        self._bus = bus

    def _emit(self, kind: str, **fields) -> None:
        if self._bus is not None:
            self._bus.emit(kind, **fields)

    def _give_up(self, reason: str, plan: LaunchPlan, world: int) -> None:
        self._log(f"supervisor: giving up — {reason}")
        self._emit("supervisor_done", outcome="gave_up", reason=reason,
                   restarts=plan.attempt, world_size=world,
                   budget_spent=self.policy.spent,
                   storm_charges=self.policy.storm_charges)

    def run(self) -> SupervisorResult:
        deadline = self._clock() + self.deadline_s
        world = self.launcher.world_size
        plan = LaunchPlan(world_size=world)
        events: list[SupervisorEvent] = []

        def result(outcome, reason, outputs, detected_by):
            return SupervisorResult(
                outcome=outcome, reason=reason, restarts=plan.attempt,
                world_size=world, resume_step=plan.resume_step,
                detected_by=detected_by, outputs=outputs, events=events,
                budget_spent=self.policy.spent,
                storm_charges=self.policy.storm_charges)

        while True:
            self._emit("gang_launch", attempt=plan.attempt,
                       world_size=plan.world_size,
                       resume_step=plan.resume_step,
                       restore_ranks=(list(plan.restore_ranks)
                                      if plan.restore_ranks is not None
                                      else None))
            gang = self.launcher.launch(plan)
            monitor = (self.monitor_factory(world)
                       if self.monitor_factory else None)
            failure = self._watch(gang, monitor, deadline)
            if failure is None:
                self._emit("supervisor_done", outcome="completed",
                           reason=None, restarts=plan.attempt,
                           world_size=world,
                           budget_spent=self.policy.spent,
                           storm_charges=self.policy.storm_charges)
                return result("completed", None, gang.outputs(),
                              events[-1].detected_by if events else None)
            gang.kill()
            charge = self.policy.record_failure()
            events.append(SupervisorEvent(
                attempt=plan.attempt, world_size=world, rank=failure.rank,
                detected_by=failure.detected_by,
                permanent=failure.permanent, charge=charge))
            self._emit("rank_failure", attempt=plan.attempt,
                       world_size=world, failed_rank=failure.rank,
                       detected_by=failure.detected_by,
                       permanent=failure.permanent, charge=charge)
            if self.policy.exhausted():
                storm = (f", {self.policy.storm_charges} storm-doubled"
                         if self.policy.storm_charges else "")
                reason = (
                    f"restart budget exhausted: {self.policy.failures} "
                    f"failures charged {self.policy.spent} against "
                    f"max_restarts={self.policy.max_restarts}{storm}; "
                    f"last: rank {failure.rank} ({failure.detected_by})")
                self._give_up(reason, plan, world)
                return result("gave_up", reason, gang.outputs(),
                              failure.detected_by)
            if failure.permanent:
                survivors = [r for r in range(world) if r != failure.rank]
                if len(survivors) < self.min_world:
                    reason = (
                        f"rank {failure.rank} permanently lost "
                        f"({failure.detected_by}) at world size {world}; "
                        f"surviving world {len(survivors)} is below "
                        f"min_world={self.min_world}")
                    self._give_up(reason, plan, world)
                    return result("gave_up", reason, gang.outputs(),
                                  failure.detected_by)
                done = self.launcher.completed_steps(survivors)
                if set(done) >= set(survivors):
                    resume = min(done[r] for r in survivors)
                    restore = tuple(survivors)
                else:
                    resume, restore = None, None   # fresh, but smaller
                self._emit("gang_shrink", from_world=world,
                           to_world=len(survivors),
                           lost_rank=failure.rank, resume_step=resume,
                           restore_ranks=(list(restore)
                                          if restore is not None
                                          else None))
                world = len(survivors)
                self._log(
                    f"supervisor: rank {failure.rank} permanently lost "
                    f"({failure.detected_by}); shrinking gang to world "
                    f"size {world}"
                    + (f", resuming from checkpoint step {resume}"
                       if resume is not None else ", restarting fresh"))
            else:
                done = self.launcher.completed_steps(list(range(world)))
                if len(done) == world:
                    resume, restore = min(done.values()), None
                    self._emit("gang_restart", world_size=world,
                               resume_step=resume)
                    self._log(
                        f"supervisor: rank {failure.rank} dead "
                        f"({failure.detected_by}); restarting gang from "
                        f"checkpoint step {resume}")
                else:
                    # a rank died before every rank had a durable
                    # checkpoint: restart fresh, since a resume step
                    # would point ranks at files that do not exist
                    resume, restore = None, None
                    self._emit("gang_restart", world_size=world,
                               resume_step=None)
                    self._log(
                        f"supervisor: rank {failure.rank} dead "
                        f"({failure.detected_by}) before all ranks "
                        f"checkpointed ({len(done)}/{world}); restarting "
                        f"fresh")
            self._sleep(self.policy.next_delay())
            plan = LaunchPlan(world_size=world, attempt=plan.attempt + 1,
                              resume_step=resume, restore_ranks=restore)

    def _watch(self, gang: Gang, monitor, deadline) -> _Failure | None:
        """Block until the gang completes (``None``) or one failure is
        attributed. Raises :class:`SupervisorTimeout` at the deadline."""
        while True:
            if self._clock() > deadline:
                gang.kill()
                raise SupervisorTimeout(
                    f"supervised run exceeded its {self.deadline_s:.0f}s "
                    f"deadline; rank logs: " + " | ".join(gang.tails()))
            codes = gang.poll()
            if all(c == 0 for c in codes):
                return None
            bad = [(r, c) for r, c in enumerate(codes)
                   if c is not None and c != 0]
            if bad:
                # a permanent-loss exit wins the attribution: peers torn
                # out of the collective often exit non-zero too, and a
                # same-size restart on a peer's code would miss the shrink
                perm = [(r, c) for r, c in bad
                        if c in self.permanent_exit_codes]
                rank, code = perm[0] if perm else bad[0]
                return _Failure(rank=rank, detected_by=f"exit={code}",
                                permanent=bool(perm))
            if monitor is not None:
                stale = monitor.stale_ranks()
                if stale:
                    return _Failure(
                        rank=stale[0],
                        detected_by=f"heartbeat>{monitor.timeout_s}s",
                        permanent=False)
            self._sleep(self.poll_interval_s)
