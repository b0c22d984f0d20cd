"""Serving (L6) of the port: the bucketed inference engine (one CUDA
graph per bucket on the card), the continuous-batching policy server,
its benches, and fleet replay. ``python -m rlgpuschedule_tpu_torch.serve``
is the CLI."""
from .batching import (DeadlineSheddedError, Ewma, PolicyServer,
                       Reservoir, ServeResult, ServerClosedError,
                       next_bucket, pad_batch, scatter_results,
                       stack_requests)
from .bench import (StubEngine, build_request_pool, default_request_sizes,
                    run_bench, run_host_path, run_soak)
from .engine import InferenceEngine
from .fleet import fleet_replay, fleet_windows

__all__ = [
    "InferenceEngine", "PolicyServer", "ServeResult",
    "DeadlineSheddedError", "ServerClosedError", "Ewma", "Reservoir",
    "next_bucket", "pad_batch", "stack_requests", "scatter_results",
    "StubEngine", "build_request_pool", "default_request_sizes",
    "run_bench", "run_host_path", "run_soak",
    "fleet_replay", "fleet_windows",
]
