"""L6 auxiliary utilities of the port: metrics logging, profiling and
tracing (the JAX package's ``utils/``). Its ``utils/platform.py`` (JAX
platform pinning and the persistent compile cache) has no counterpart:
the port compiles no XLA program and picks its device per call."""
from .logging import MetricsLogger, TensorBoardWriter, ThroughputMeter
from .profiling import SectionTimer, TraceSession, debug_checks, trace

__all__ = ["MetricsLogger", "TensorBoardWriter", "ThroughputMeter",
           "trace", "TraceSession", "debug_checks", "SectionTimer"]
