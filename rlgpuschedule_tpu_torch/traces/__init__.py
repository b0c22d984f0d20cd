"""L0 trace layer of the port: records, the synthetic generator and the
Philly-statistics proxy (numpy copies of the JAX package's modules)."""
from .philly_proxy import gen_philly_proxy_jobs, gen_philly_proxy_trace
from .records import (STATUS_FAILED, STATUS_KILLED, STATUS_PASS,
                      ArrayTrace, JobRecord, to_array_trace)
from .synthetic import gen_poisson_jobs, gen_poisson_trace

__all__ = [
    "JobRecord", "ArrayTrace", "to_array_trace",
    "STATUS_PASS", "STATUS_KILLED", "STATUS_FAILED",
    "gen_poisson_jobs", "gen_poisson_trace",
    "gen_philly_proxy_jobs", "gen_philly_proxy_trace",
]
