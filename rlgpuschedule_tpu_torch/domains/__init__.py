"""L6 domain randomization of the port (see :mod:`.schedule`)."""
from .schedule import (DOMAIN_REGIMES, DomainDraw, DomainSchedule,
                       DomainSpec, domain_schedule, domain_stats,
                       resolve_domain, sample_domain, sample_env_domains,
                       stack_domain_schedules, validate_domain_schedule)

__all__ = [
    "DOMAIN_REGIMES", "DomainDraw", "DomainSchedule", "DomainSpec",
    "domain_schedule", "domain_stats", "resolve_domain", "sample_domain",
    "sample_env_domains", "stack_domain_schedules",
    "validate_domain_schedule",
]
