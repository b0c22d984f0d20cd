"""The port's telemetry against the JAX package's: the metrics
registry's exposition byte for byte, the SLO engine's status under one
fake clock, the event bus and tracer records field for field, and the
live scrape endpoint."""
import os
import socket
import urllib.error
import urllib.request

import pytest

from rlgpuschedule_tpu.obs import events as jevents
from rlgpuschedule_tpu.obs import metrics as jmetrics
from rlgpuschedule_tpu.obs import slo as jslo
from rlgpuschedule_tpu.obs import trace as jtrace
from rlgpuschedule_tpu_torch.obs import events as tevents
from rlgpuschedule_tpu_torch.obs import metrics as tmetrics
from rlgpuschedule_tpu_torch.obs import slo as tslo
from rlgpuschedule_tpu_torch.obs import trace as ttrace


def _fill(m, reg):
    """One sequence of registrations and updates, applied to a registry
    of either package (``m`` is its metrics module)."""
    c = reg.counter("serve_requests_total", "requests submitted")
    c.inc()
    c.inc(4)
    for e in ("0", "1"):
        reg.counter("serve_engine_rows_total", "rows per engine",
                    labels={"engine": e}).inc(3 + int(e))
    reg.counter("serve_engine_rows_total", labels={"engine": "0"}).inc(0.5)
    g = reg.gauge("serve_queue_depth", "requests waiting")
    g.set(7)
    g.set(2.25)
    reg.gauge("serve_tiny", "").set(1.5e-9)
    reg.gauge("serve_big").set(123456789.0)
    h = reg.histogram("serve_latency_seconds", "latency")
    for v in (0.0004, 0.003, 0.003, 0.07, 3.0, 42.0):
        h.observe(v)
    h2 = reg.histogram("serve_wait_seconds", "wait", buckets=(0.1, 1.0))
    h2.observe(0.5)
    derived = reg.gauge("serve_derived", "set by a collector")
    reg.add_collector(lambda: derived.set(c.value * 2))
    reg.add_collector(lambda: 1 / 0)          # swallowed and counted
    assert isinstance(reg, m.Registry)
    return reg


def test_registry_exposition_is_byte_equal_to_jax(tmp_path):
    j = _fill(jmetrics, jmetrics.Registry())
    t = _fill(tmetrics, tmetrics.Registry())
    assert t.render() == j.render()
    assert t.collector_errors == j.collector_errors == 1
    j.write(str(tmp_path / "j" / "metrics.prom"))
    t.write(str(tmp_path / "t" / "metrics.prom"))
    assert ((tmp_path / "t" / "metrics.prom").read_bytes()
            == (tmp_path / "j" / "metrics.prom").read_bytes())
    assert "serve_derived 10" in t.render()


@pytest.mark.parametrize("bad", [
    lambda r: (r.counter("x_total"), r.gauge("x_total")),
    lambda r: r.counter("bad name"),
    lambda r: r.counter("y_total", labels={"k": "a b"}),
    lambda r: r.counter("z_total").inc(-1),
    lambda r: r.histogram("h", buckets=(1.0, 0.5)),
    lambda r: (r.histogram("h2", buckets=(1.0,)),
               r.histogram("h2", buckets=(2.0,))),
], ids=["kind", "name", "label", "negative", "order", "moved"])
def test_registry_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        bad(jmetrics.Registry())
    with pytest.raises(ValueError):
        bad(tmetrics.Registry())


def test_registry_returns_the_same_series_and_removes_collectors():
    reg = tmetrics.Registry()
    assert reg.counter("a_total") is reg.counter("a_total")
    calls = []
    fn = lambda: calls.append(1)              # noqa: E731
    reg.add_collector(fn)
    reg.add_collector(fn)                     # idempotent
    reg.render()
    reg.remove_collector(fn)
    reg.remove_collector(fn)                  # no-op when absent
    reg.render()
    assert calls == [1]


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _slo_run(m, reg, bus_dir):
    """Feed one SLI sequence through an SLO engine of either package under
    a fake clock; returns the status after every collect."""
    clock = _Clock()
    bus = (jevents if m is jslo else tevents).EventBus(
        str(bus_dir), rank=0, name="slo", clock=lambda: 0.0,
        wall=lambda: 0.0)
    eng = m.SLOEngine(reg, bus=bus, clock=clock)
    state = {"bad": 0.0, "total": 0.0}
    eng.watch(m.SLOSpec("availability", objective=0.99,
                        windows=((5.0, 2.0), (30.0, 1.0)),
                        budget_window_s=30.0),
              lambda: (state["bad"], state["total"]))
    hist = reg.histogram("wait_seconds", "wait")
    eng.watch(m.SLOSpec("queue-latency", objective=0.95,
                        windows=((1.0, 1.0), (3.0, 1.0))),
              m.histogram_sli(hist, 0.25))
    out = []
    for step, (bad, total, waits) in enumerate(
            [(0, 10, [0.01] * 10), (0, 30, [0.01] * 20),
             (8, 40, [0.5] * 10), (20, 60, [2.0] * 20), (20, 90, [0.1] * 30),
             (20, 100, [0.01] * 10), (20, 200, [0.01] * 100),
             (20, 400, [0.01] * 200)]):
        state.update(bad=float(bad), total=float(total))
        for w in waits:
            hist.observe(w)
        clock.t += 0.5 + step
        reg.collect()
        out.append(eng.status())
    eng.close()
    bus.close()
    return out, reg.render()


def test_slo_engine_status_equals_jax_under_one_clock(tmp_path):
    j, j_render = _slo_run(jslo, jmetrics.Registry(), tmp_path / "j")
    t, t_render = _slo_run(tslo, tmetrics.Registry(), tmp_path / "t")
    assert t == j
    assert t_render == j_render
    # the sequence alerts and clears, so both edges were compared
    assert any(s["availability"]["alerting"] for s in t)
    assert not t[-1]["availability"]["alerting"]
    je = jevents.read_events(jevents.stream_path(str(tmp_path / "j"), "slo"))
    te = tevents.read_events(tevents.stream_path(str(tmp_path / "t"), "slo"))
    drop = ("pid",)
    assert [{k: v for k, v in e.items() if k not in drop} for e in te] == \
        [{k: v for k, v in e.items() if k not in drop} for e in je]
    assert {e["kind"] for e in te} >= {"slo_burn_alert", "slo_burn_clear"}


def test_slo_spec_validation_matches_jax():
    for kw in (dict(objective=1.0), dict(objective=0.9, windows=()),
               dict(objective=0.9, windows=((0.0, 1.0),)),
               dict(objective=0.9, budget_window_s=-1.0)):
        with pytest.raises(ValueError):
            jslo.SLOSpec("x", **kw)
        with pytest.raises(ValueError):
            tslo.SLOSpec("x", **kw)
    h = tmetrics.Histogram("h")
    with pytest.raises(ValueError, match="below the lowest"):
        tslo.histogram_sli(h, 1e-6)


def _trace_run(ev, tr, d):
    """Spans, instants and a lane on a bus of either package."""
    ticks = iter(range(1000))
    bus = ev.EventBus(str(d), rank=3, name="serve",
                      clock=lambda: float(next(ticks)), wall=lambda: 0.0)
    tracer = tr.Tracer(bus, enabled=True)
    with tracer.span("serve_batch", n=5):
        with tracer.span("pad"):
            pass
        tracer.instant("served", bucket=8, req_ids=[1, 2])
    tracer.instant("enqueue")
    lane = tracer.lane("engine0")
    with lane.span("dispatch", bucket=8):
        lane.instant("replay")
    with pytest.raises(ZeroDivisionError):
        with tracer.span("fails"):
            1 / 0
    bus.emit("compile", scope="serve", bucket=8)
    with pytest.raises(ValueError, match="shadow"):
        bus.emit("x", seq=3)
    assert tr.NULL_TRACER.span("x") is tr.NULL_TRACER.span("y")
    assert tr.NULL_TRACER.lane("l").enabled is False
    bus.close()
    return ev.read_events(bus.path)


def test_tracer_and_bus_records_carry_the_jax_fields(tmp_path):
    j = _trace_run(jevents, jtrace, tmp_path / "j")
    t = _trace_run(tevents, ttrace, tmp_path / "t")
    stamps = ("mono", "wall", "pid")
    assert len(t) == len(j) == 12
    for a, b in zip(t, j):
        assert set(a) == set(b)
        assert ({k: v for k, v in a.items() if k not in stamps}
                == {k: v for k, v in b.items() if k not in stamps})
    assert [e["seq"] for e in t] == list(range(12))


def test_event_readers_match_jax(tmp_path):
    for name, rank, ticks in (("rank0", 0, (0.5, 2.0, 3.0)),
                              ("rank1", 1, (1.0, 2.0, 2.5))):
        it = iter(ticks)
        bus = tevents.EventBus(str(tmp_path), rank=rank, name=name,
                               clock=lambda: next(it), wall=lambda: 0.0)
        for k in range(3):
            bus.emit("iteration", iteration=k)
        bus.close()
    with open(tevents.stream_path(str(tmp_path), "rank1"), "a") as f:
        f.write('{"kind": "torn')                 # a crashed writer's tail
    assert (tevents.event_streams(str(tmp_path))
            == jevents.event_streams(str(tmp_path)))
    merged = tevents.merge_dir(str(tmp_path))
    assert merged == jevents.merge_dir(str(tmp_path))
    assert [(e["rank"], e["seq"]) for e in merged] == \
        [(0, 0), (1, 0), (0, 1), (1, 1), (1, 2), (0, 2)]
    assert tevents.merge_events(reversed(merged)) == merged
    with pytest.raises(FileNotFoundError):
        tevents.merge_dir(str(tmp_path / "empty"))


def _port_is_free(port):
    """Bindable again, as a restarted endpoint binds it (the closed
    connections' TIME_WAIT entries do not block SO_REUSEADDR; a listener
    that is still open does)."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


def test_scrape_endpoint_serves_the_exposition_and_frees_its_port():
    reg = _fill(tmetrics, tmetrics.Registry())
    srv = tmetrics.serve_http(reg, port=0)
    assert not _port_is_free(srv.port)
    try:
        with urllib.request.urlopen(srv.url, timeout=10) as resp:
            body = resp.read().decode()
            assert resp.status == 200
            assert resp.headers["Content-Type"] == \
                tmetrics.EXPOSITION_CONTENT_TYPE
        assert body == reg.render()
        root = srv.url.rsplit("/", 1)[0] + "/"
        with urllib.request.urlopen(root, timeout=10) as resp:
            assert resp.status == 200
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(root + "nope", timeout=10)
        assert e.value.code == 404
    finally:
        srv.close()
    assert _port_is_free(srv.port)
    with tmetrics.MetricsHTTPServer(reg, port=srv.port) as again:
        assert again.port == srv.port


def test_obs_package_exports_the_slice():
    import rlgpuschedule_tpu_torch.obs as obs
    for name in ("EventBus", "Registry", "serve_http", "Tracer",
                 "TracerLane", "NULL_TRACER", "SLOEngine", "SLOSpec",
                 "histogram_sli", "merge_dir", "read_events"):
        assert getattr(obs, name) is not None, name
    assert os.path.basename(obs.metrics.__file__) == "metrics.py"
