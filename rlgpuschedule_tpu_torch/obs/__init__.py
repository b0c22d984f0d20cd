"""Telemetry (L6 aux) of the port: the event bus, the metrics registry
and its scrape endpoint, span tracing and the SLO burn-rate engine.

Pure-Python copies of the JAX package's ``obs/`` modules of the same
names, so a serving run of either package exposes the same metrics
and writes the same events:

- :mod:`.events` -- append-only JSONL streams stamped ``(v, kind, rank,
  pid, seq, mono, wall)``; :func:`merge_dir` orders per-rank streams;
- :mod:`.metrics` -- counters, gauges and histograms rendered as the
  Prometheus text exposition, to a file (``Registry.write``) or a live
  scrape endpoint (:func:`serve_http`);
- :mod:`.trace` -- nestable, thread-aware spans and instants on the bus;
- :mod:`.slo` -- declarative SLOs evaluated as multi-window burn rates
  by a pre-scrape collector hook.

The run-loop telemetry, the post-mortem report, the clock-skew merge
and the span readers wait for the observability slice (``ROADMAP.md``
queue 1, item 24).
"""
from .events import (SCHEMA_VERSION, EventBus, event_streams, merge_dir,
                     merge_events, read_events)
from .metrics import (Counter, Gauge, Histogram, MetricsHTTPServer,
                      Registry, serve_http)
from .slo import DEFAULT_WINDOWS, SLOEngine, SLOSpec, histogram_sli
from .trace import NULL_TRACER, Tracer, TracerLane

__all__ = [
    "EventBus", "SCHEMA_VERSION", "event_streams", "merge_dir",
    "merge_events", "read_events",
    "Counter", "Gauge", "Histogram", "MetricsHTTPServer", "Registry",
    "serve_http",
    "NULL_TRACER", "Tracer", "TracerLane",
    "DEFAULT_WINDOWS", "SLOEngine", "SLOSpec", "histogram_sli",
]
