"""Serving (L6) of the port: the bucketed inference engine and fleet
replay. ``python -m rlgpuschedule_tpu_torch.serve`` is the CLI."""
from .batching import next_bucket, pad_batch
from .engine import InferenceEngine
from .fleet import fleet_replay, fleet_windows

__all__ = ["InferenceEngine", "next_bucket", "pad_batch", "fleet_replay",
           "fleet_windows"]
