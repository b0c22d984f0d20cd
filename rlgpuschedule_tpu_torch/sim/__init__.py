"""L1 simulator of the port (see :mod:`.core`)."""
from .core import (DONE, NOT_ARRIVED, PACK, PENDING, RUNNING, SPREAD,
                   SimParams, SimState, StepInfo, Trace, validate_trace)

__all__ = ["SimParams", "SimState", "StepInfo", "Trace", "validate_trace",
           "NOT_ARRIVED", "PENDING", "RUNNING", "DONE", "PACK", "SPREAD"]
