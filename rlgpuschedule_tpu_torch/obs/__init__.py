"""Telemetry (L6 aux) of the port: the event bus, the metrics registry
and its scrape endpoint, span tracing, the SLO burn-rate engine, the
clock-skew merge, the run-loop telemetry and alarms, and the
post-mortem report.

Pure-Python copies of the JAX package's ``obs/`` modules of the same
names, so a serving run of either package exposes the same metrics
and writes the same events, and either package's report reads both:

- :mod:`.events` -- append-only JSONL streams stamped ``(v, kind, rank,
  pid, seq, mono, wall)``; :func:`merge_dir` orders per-rank streams;
- :mod:`.metrics` -- counters, gauges and histograms rendered as the
  Prometheus text exposition, to a file (``Registry.write``) or a live
  scrape endpoint (:func:`serve_http`);
- :mod:`.trace` -- nestable, thread-aware spans and instants on the bus,
  and their readers: the span tree, the measured async overlap and the
  Chrome-trace export;
- :mod:`.slo` -- declarative SLOs evaluated as multi-window burn rates
  by a pre-scrape collector hook;
- :mod:`.skew` -- per-rank clock offsets learned from the bus's
  ``(wall, mono)`` stamps, and a merged timeline rewritten onto one
  corrected axis;
- :mod:`.telemetry` -- :class:`RunTelemetry`, what ``Experiment.run``
  and ``PopulationExperiment.run`` hold (iteration spans with a
  step/sync/eval/ckpt/resample phase breakdown, no host read of its
  own), and :class:`Alarms`, the recompile, transfer and slow-iteration
  alarms (``CompileCounter`` and the sync guard of
  :mod:`..analysis.sentinels` in production; the slow-iteration capture
  is a torch profiler trace), and the async engine's
  :class:`OverlapMeter` and :class:`AsyncGauges`;
- :mod:`.report` -- ``python -m rlgpuschedule_tpu_torch.obs.report
  <dir> [--request ID]``: the run post-mortem, or one request's
  timeline.
"""
from .events import (SCHEMA_VERSION, EventBus, event_streams, merge_dir,
                     merge_events, read_events)
from .metrics import (Counter, Gauge, Histogram, MetricsHTTPServer,
                      Registry, serve_http)
from .skew import (RankSkew, correct_events, learn_offsets,
                   merge_dir_corrected)
from .slo import DEFAULT_WINDOWS, SLOEngine, SLOSpec, histogram_sli
from .telemetry import (PROM_SNAPSHOT, AlarmError, Alarms, AsyncGauges,
                        OverlapMeter, RunTelemetry)
from .trace import (NULL_TRACER, Tracer, TracerLane, async_overlap_summary,
                    build_span_tree, to_chrome_trace, tracer_of)

__all__ = [
    "EventBus", "SCHEMA_VERSION", "event_streams", "merge_dir",
    "merge_events", "read_events",
    "Counter", "Gauge", "Histogram", "MetricsHTTPServer", "Registry",
    "serve_http",
    "AlarmError", "Alarms", "AsyncGauges", "OverlapMeter", "PROM_SNAPSHOT",
    "RunTelemetry",
    "NULL_TRACER", "Tracer", "TracerLane", "async_overlap_summary",
    "build_span_tree", "to_chrome_trace", "tracer_of",
    "RankSkew", "correct_events", "learn_offsets", "merge_dir_corrected",
    "DEFAULT_WINDOWS", "SLOEngine", "SLOSpec", "histogram_sli",
]
