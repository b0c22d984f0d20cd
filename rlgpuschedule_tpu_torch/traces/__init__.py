"""L0 trace layer of the port: records, the synthetic generator, the
Philly and PAI statistics proxies, the Philly/PAI CSV loaders and the
workload fits (numpy copies of the JAX package's modules)."""
from .fit import (PAI_FIT, PHILLY_FIT, TraceFit, domain_fit,
                  fit_hourly_curve, fit_jobs, gen_domain_window)
from .pai import load_pai, load_pai_jobs
from .philly import load_philly, load_philly_jobs
from .philly_proxy import (gen_pai_proxy_jobs, gen_pai_proxy_trace,
                           gen_philly_proxy_jobs, gen_philly_proxy_trace)
from .records import (STATUS_FAILED, STATUS_KILLED, STATUS_PASS,
                      ArrayTrace, JobRecord, parse_status, to_array_trace)
from .synthetic import gen_poisson_jobs, gen_poisson_trace

__all__ = [
    "JobRecord", "ArrayTrace", "to_array_trace", "parse_status",
    "STATUS_PASS", "STATUS_KILLED", "STATUS_FAILED",
    "gen_poisson_jobs", "gen_poisson_trace",
    "gen_philly_proxy_jobs", "gen_philly_proxy_trace",
    "gen_pai_proxy_jobs", "gen_pai_proxy_trace",
    "load_philly", "load_philly_jobs", "load_pai", "load_pai_jobs",
    "TraceFit", "fit_jobs", "fit_hourly_curve", "domain_fit",
    "gen_domain_window", "PHILLY_FIT", "PAI_FIT",
]
