"""Serving (L6) of the port: the bucketed inference engine (one CUDA
graph per bucket on the card), the continuous-batching policy server,
the multi-engine router with its fault injector and autoscale advisor,
their benches, fleet replay, and the network front door (asyncio HTTP
and the framed :mod:`.wire` dialect on one port). ``python -m
rlgpuschedule_tpu_torch.serve`` is the CLI."""
from . import wire
from .batching import (DeadlineSheddedError, Ewma, PolicyServer,
                       Reservoir, ServeResult, ServerClosedError,
                       next_bucket, pad_batch, scatter_results,
                       stack_requests)
from .bench import (StubEngine, build_request_pool, default_request_sizes,
                    fit_paced_gaps, run_bench, run_chaos_soak,
                    run_host_path, run_scaleout, run_soak)
from .engine import InferenceEngine
from .fleet import fleet_replay, fleet_windows
from .frontend import FrontendHandle, ServeFrontend, start_frontend
from .router import (SERVE_FAULT_KINDS, AutoscaleAdvisor, EngineRouter,
                     EngineStats, InjectedEngineFault, ServeFaultInjector,
                     ServeFaultSpec, parse_serve_fault)

__all__ = [
    "InferenceEngine", "PolicyServer", "ServeResult",
    "DeadlineSheddedError", "ServerClosedError", "Ewma", "Reservoir",
    "EngineRouter", "AutoscaleAdvisor", "EngineStats",
    "SERVE_FAULT_KINDS", "ServeFaultSpec", "ServeFaultInjector",
    "InjectedEngineFault", "parse_serve_fault",
    "ServeFrontend", "FrontendHandle", "start_frontend", "wire",
    "next_bucket", "pad_batch", "stack_requests", "scatter_results",
    "StubEngine", "build_request_pool", "default_request_sizes",
    "run_bench", "run_host_path", "run_soak", "run_scaleout",
    "run_chaos_soak", "fit_paced_gaps",
    "fleet_replay", "fleet_windows",
]
