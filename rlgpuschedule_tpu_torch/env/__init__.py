"""L2 environment of the port (see :mod:`.env`)."""
from .env import (EnvParams, EnvState, TimeStep, reset, stack_traces, step,
                  vec_reset, vec_step)

__all__ = ["EnvParams", "EnvState", "TimeStep", "reset", "step",
           "vec_reset", "vec_step", "stack_traces"]
