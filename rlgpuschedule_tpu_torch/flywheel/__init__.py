"""The data flywheel of the port: serve -> log -> retrain -> promote.

Counterpart of the JAX package's ``flywheel/``:

- :mod:`.flightlog`: the crash-safe served-traffic log (one recycled
  shard buffer, crc32 sidecars, torn-tail-tolerant reads,
  ``rows_logged == served``), JAX's on-disk format;
- :mod:`.continual`: ``train --continual LOGDIR``, V-trace-corrected
  retraining from logged shards behind a measured-staleness,
  importance-ratio trust region;
- :mod:`.canary`: canary-gated promotion (a logged window replayed
  under both weights, a hysteresis gate), the post-swap SLO watchdog
  and the crc-sidecar'd promotion ledger.

Event kinds: ``flywheel_shard_seal`` (the writer), ``promote_blocked``
(the canary), ``promote_apply`` (the serve CLI's promotion driver),
``promote_rollback`` (the watchdog); none is an alarm kind.
"""
from .canary import (CanaryReport, LedgerCorruptError, PromotionLedger,
                     SLOWatchdog, action_agreement, read_ledger,
                     replay_decisions, run_canary)
from .continual import (IngestReport, admit_shards, gate_logged_mask,
                        run_continual, shard_rho_stats,
                        shards_to_transition)
from .flightlog import (FlightLogCorruptError, FlightLogData,
                        FlightLogError, FlightLogWriter, FlightShard,
                        read_flight_log, unflatten_like)

__all__ = [
    "CanaryReport", "FlightLogCorruptError", "FlightLogData",
    "FlightLogError", "FlightLogWriter", "FlightShard", "IngestReport",
    "LedgerCorruptError", "PromotionLedger", "SLOWatchdog",
    "action_agreement", "admit_shards", "gate_logged_mask",
    "read_flight_log", "read_ledger", "replay_decisions", "run_canary",
    "run_continual", "shard_rho_stats", "shards_to_transition",
    "unflatten_like",
]
