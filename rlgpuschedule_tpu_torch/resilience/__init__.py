"""Fault tolerance (L6 aux) of the port: the divergence watchdog, fault
injection, heartbeats and the gang supervisor's logic.

Counterpart of the JAX package's ``resilience/``, on one host:

- :class:`DivergenceWatchdog` -- per-iteration non-finite and loss
  blow-up detection, rollback to the last good checkpoint with a
  deterministically decayed LR, a clean give-up after
  ``max_rollbacks`` (``Experiment.run`` and
  ``PopulationExperiment.run`` take it as ``watchdog=``);
- :class:`FaultInjector` / :func:`parse_fault` -- the deterministic
  fault-injection harness (``nan-grad@K``, ``corrupt-ckpt@K``,
  ``kill-rank@T[:rank=R]``, ``lose-rank@T[:rank=R]``) behind the train
  CLI's ``--fault``; :func:`corrupt_checkpoint` truncates the port's
  ``state.pt``;
- :class:`HeartbeatWriter` / :class:`HeartbeatMonitor` -- per-rank
  heartbeat files (monotonic stamps, atomic writes) and their staleness
  check;
- :class:`Supervisor` / :class:`RestartPolicy` / :class:`Launcher` --
  the elastic gang supervisor's detect -> decide -> relaunch loop,
  driven by any :class:`Launcher`.

The subprocess gang launcher (JAX's ``SubprocessGangLauncher``) starts
the multihost worker, so it comes with the data-parallel slice
(``ROADMAP.md`` queue 1, item 21), as does the elastic restore.
Checkpoint integrity (the crc32 pre-check, then the fallback to the
previous retained step) lives in ``checkpoint.Checkpointer``.
"""
from .faults import (KILL_RANK_EXIT, LOSE_RANK_EXIT, FaultInjector,
                     FaultSpec, corrupt_checkpoint, parse_fault)
from .heartbeat import HeartbeatMonitor, HeartbeatWriter
from .supervisor import (Gang, Launcher, LaunchPlan, RestartPolicy,
                         Supervisor, SupervisorEvent, SupervisorResult,
                         SupervisorTimeout)
from .watchdog import DivergenceError, DivergenceWatchdog, RollbackEvent

__all__ = [
    "DivergenceError", "DivergenceWatchdog", "RollbackEvent",
    "FaultInjector", "FaultSpec", "corrupt_checkpoint", "parse_fault",
    "KILL_RANK_EXIT", "LOSE_RANK_EXIT",
    "HeartbeatMonitor", "HeartbeatWriter",
    "Gang", "Launcher", "LaunchPlan", "RestartPolicy",
    "Supervisor", "SupervisorEvent",
    "SupervisorResult", "SupervisorTimeout",
]
