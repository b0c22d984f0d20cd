"""Counters/gauges registry with a Prometheus-style text snapshot.

The port's copy of the JAX package's ``obs/metrics.py`` (pure Python,
no JAX): the exposition is byte for byte the same after the same
sequence of updates.

The event bus answers "what happened, when"; this registry answers "how
much, right now" — monotonically increasing counters (iterations run,
recompile alarms fired) and point-in-time gauges (steps/s). The snapshot
is the Prometheus *text exposition format*, delivered two ways:

- a file (``Registry.write``): training hosts usually can't open ports,
  but every fleet scraper (node-exporter textfile collector, a sidecar,
  plain ``cat``) can read a file;
- an actual scrape endpoint (:func:`serve_http`): a serving host
  IS a network service already, so its SLO gauges are scraped live over
  HTTP — a stdlib ``http.server`` thread rendering the same exposition,
  no new dependency (closing the "snapshot to an actual scrape endpoint
  rather than files" deployment residual).

Dependency-free by the same argument as the hand-rolled TensorBoard
writer in ``utils.logging``: the write cadence is one small file per
logged iteration, so a client library would buy nothing.
"""
from __future__ import annotations

import os
import re
from typing import Union

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _label_suffix(labels: "dict[str, str] | None") -> str:
    """Canonical ``{k="v",...}`` rendering (sorted keys) — the identity
    of one series within a metric family. Label values may not contain
    spaces, quotes, or newlines: the exposition stays one
    whitespace-splittable ``name{labels} value`` line per series."""
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k])
        if not _LABEL_NAME_RE.match(k):
            raise ValueError(f"bad label name {k!r} (want "
                             f"{_LABEL_NAME_RE.pattern})")
        if any(c in v for c in ' "\n\\'):
            raise ValueError(f"label {k}={v!r}: values must be free of "
                             f"spaces/quotes/backslashes/newlines")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


class Counter:
    """Monotonically increasing value. ``inc`` refuses negative deltas —
    a decreasing counter corrupts every rate() computed from it."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self.value += n


class Gauge:
    """Point-in-time value; may move in either direction."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Prometheus histogram: cumulative ``_bucket{le=...}`` counts plus
    ``_sum``/``_count`` (text exposition format 0.0.4), so scrape-side
    ``histogram_quantile()`` computes p50/p99 across restarts and ranks
    without any in-process sample list. Buckets are fixed at
    registration (a histogram whose buckets move between scrapes is
    unaggregatable); the default ladder suits sub-second latencies.
    """

    kind = "histogram"

    DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                       0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self, name: str, help: str = "",
                 buckets: tuple[float, ...] | None = None):
        self.name = name
        self.help = help
        b = tuple(float(x) for x in
                  (buckets if buckets is not None else
                   self.DEFAULT_BUCKETS))
        if not b or list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError(f"histogram {name}: buckets must be a "
                             f"non-empty strictly increasing sequence, "
                             f"got {b}")
        self.buckets = b
        self._counts = [0] * len(b)     # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        for i, le in enumerate(self.buckets):
            if v <= le:
                self._counts[i] += 1
                break

    def cumulative(self) -> list[tuple[float, int]]:
        """``(le, cumulative_count)`` rows; the implicit ``+Inf`` bucket
        (== ``count``) is the renderer's last line."""
        out, acc = [], 0
        for le, n in zip(self.buckets, self._counts):
            acc += n
            out.append((le, acc))
        return out


def _fmt_le(le: float) -> str:
    return f"{le:g}"


class Registry:
    """Name (+ optional labels) -> metric registry.

    Re-registering an existing series returns the SAME object (call
    sites in different subsystems may race to declare a shared metric),
    but a kind mismatch raises — silently returning a counter where a
    gauge was requested corrupts the snapshot's TYPE line.

    ``labels`` carves one metric *family* into per-series
    values — ``serve_engine_dispatches_total{engine="1"}`` — which is
    how the multi-engine router exports per-engine occupancy without
    minting a metric name per engine (a scraper aggregates label series
    with ``sum by``; it cannot aggregate name suffixes). Labeled and
    unlabeled series may coexist under one family name; the kind and
    HELP/TYPE header are per family.
    """

    def __init__(self):
        # (name, rendered-label-suffix) -> metric; the family header
        # (kind + help) is resolved from the first-registered series
        self._metrics: dict[tuple[str, str],
                            Union[Counter, Gauge, Histogram]] = {}
        # pre-scrape collector hooks: callables run by
        # collect() before every render, so derived gauges (SLO burn
        # rates, reservoir percentiles) are recomputed at scrape time
        # instead of whenever someone last remembered to refresh them
        self._collectors: list = []
        self._in_collect = False
        self.collector_errors = 0

    def add_collector(self, fn) -> None:
        """Register a zero-arg callable to run before every render/
        scrape. Collectors refresh derived series from primary state;
        they must be cheap and must not raise (a raising collector is
        swallowed and counted in ``collector_errors`` — a broken
        refresher must never take the scrape surface down with it)."""
        if fn not in self._collectors:
            self._collectors.append(fn)

    def remove_collector(self, fn) -> None:
        """Deregister a collector (no-op if absent) — call on shutdown
        of the subsystem that owns the refreshed series."""
        try:
            self._collectors.remove(fn)
        except ValueError:
            pass

    def collect(self) -> None:
        """Run every registered collector once. Re-entrancy-guarded: a
        collector that (transitively) triggers another render observes
        the in-progress refresh instead of recursing."""
        if not self._collectors or self._in_collect:
            return
        self._in_collect = True
        try:
            for fn in list(self._collectors):
                try:
                    fn()
                except Exception:
                    self.collector_errors += 1
        finally:
            self._in_collect = False

    def _register(self, cls, name: str, help: str,
                  labels: "dict[str, str] | None" = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r} (want "
                             f"{_NAME_RE.pattern})")
        key = (name, _label_suffix(labels))
        existing = self._metrics.get(key)
        if existing is None:
            # family kind consistency: any sibling series fixes the kind
            for (n, _), m in self._metrics.items():
                if n == name and not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}, not {cls.kind}")
            existing = self._metrics[key] = cls(name, help)
        elif not isinstance(existing, cls):
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{existing.kind}, not {cls.kind}")
        return existing

    def counter(self, name: str, help: str = "",
                labels: "dict[str, str] | None" = None) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: "dict[str, str] | None" = None) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] | None = None) -> Histogram:
        key = (name, "")
        existing = self._metrics.get(key)
        if existing is None:
            if not _NAME_RE.match(name):
                raise ValueError(f"bad metric name {name!r} (want "
                                 f"{_NAME_RE.pattern})")
            h = Histogram(name, help, buckets)
            self._metrics[key] = h
            return h
        if not isinstance(existing, Histogram):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{existing.kind}, not histogram")
        if buckets is not None and tuple(float(x) for x in
                                         buckets) != existing.buckets:
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{existing.buckets}, not {tuple(buckets)} (moving "
                f"buckets between scrapes is unaggregatable)")
        return existing

    def render(self) -> str:
        """Prometheus text exposition: ``# HELP`` / ``# TYPE`` lines per
        family, then one value line per series (label-suffixed when the
        series is labeled) or the cumulative
        ``_bucket``/``_sum``/``_count`` series per histogram;
        (name, labels)-sorted for a stable diffable snapshot. Runs the
        registered collectors first — a scrape is never stale."""
        self.collect()
        lines = []
        last_family = None
        for name, suffix in sorted(self._metrics):
            m = self._metrics[(name, suffix)]
            if name != last_family:
                last_family = name
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for le, acc in m.cumulative():
                    lines.append(
                        f'{name}_bucket{{le="{_fmt_le(le)}"}} {acc}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{name}_sum {m.sum:g}")
                lines.append(f"{name}_count {m.count}")
            else:
                lines.append(f"{name}{suffix} {m.value:g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write(self, path: str) -> None:
        """Atomically replace the snapshot file (a scraper must never
        read a half-written exposition)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.render())
        os.replace(tmp, path)


# the Prometheus text exposition content type (format version 0.0.4 —
# the plain-text lingua franca every scraper accepts)
EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsHTTPServer:
    """A live scrape endpoint for one :class:`Registry`: a daemon-thread
    stdlib ``http.server`` answering ``GET /metrics`` (and ``/``) with
    the registry's current text exposition.

    Rendering happens per request under the GIL against the registry's
    plain-float metric values, so a scrape observes a consistent-enough
    point-in-time view without any locking on the hot serving path (the
    same argument the atomic file snapshot makes, minus the file).

    ``port=0`` binds an ephemeral port (tests, smoke runs);
    the resolved port is ``self.port``. Always ``close()`` (or use as a
    context manager) — the listener thread is daemonized but the socket
    is a real bound resource.
    """

    def __init__(self, registry: Registry, port: int = 0,
                 host: str = "127.0.0.1"):
        import http.server
        import threading

        reg = registry

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (http.server API)
                if self.path.split("?", 1)[0] not in ("/", "/metrics"):
                    self.send_error(404, "scrape endpoint serves /metrics")
                    return
                body = reg.render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", EXPOSITION_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass    # scrapes are periodic; stderr chatter helps nobody

        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-scrape",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "MetricsHTTPServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_http(registry: Registry, port: int = 0,
               host: str = "127.0.0.1") -> MetricsHTTPServer:
    """Start the live scrape endpoint for ``registry``; returns the
    server (``.port`` holds the resolved port, ``.close()`` stops it)."""
    return MetricsHTTPServer(registry, port=port, host=host)
