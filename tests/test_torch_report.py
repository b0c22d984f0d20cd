"""The port's post-mortem (``rlgpuschedule_tpu_torch/obs/report.py``,
``obs/skew.py`` and the readers of ``obs/trace.py``) against the JAX
package's.

Both packages' ``EventBus`` and ``Tracer`` write one scripted run into
temp dirs on the same injected clocks (two ranks, rank 1's wall clock
2.5 s ahead, heartbeats, iterations, nested and torn spans, actor and
learner lanes, rollbacks, faults, ``env_fault`` rows, serve-fleet and
SLO events, an alarm, serve instants): the streams are byte-equal, each
package reads the other's, and over one merged timeline
``build_report``, ``format_report``, ``to_chrome_trace``,
``build_span_tree``, ``async_overlap_summary``, ``learn_offsets`` and
``correct_events`` agree exactly. The CLI's exit codes (0, 1, 2),
``--strict-alarms``, ``--trace-out`` and ``--out`` are JAX's, and so is
``--request ID --flight-log DIR``, the join against a flight log (the
row's shard and outcome) and a promotion ledger (the verdicts whose
window covers it) that either package wrote. Last,
``build_request_report`` rebuilds the timelines of requests sent
through the port's front door from the port server's own stream.
"""
import dataclasses
import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from rlgpuschedule_tpu.obs import events as jevents
from rlgpuschedule_tpu.obs import report as jreport
from rlgpuschedule_tpu.obs import skew as jskew
from rlgpuschedule_tpu.obs import trace as jtrace
from rlgpuschedule_tpu_torch.obs import Registry
from rlgpuschedule_tpu_torch.obs import events as tevents
from rlgpuschedule_tpu_torch.obs import report as treport
from rlgpuschedule_tpu_torch.obs import skew as tskew
from rlgpuschedule_tpu_torch.obs import trace as ttrace
from rlgpuschedule_tpu_torch.serve import (PolicyServer, next_bucket,
                                           start_frontend, wire)

PKGS = {"jax": (jevents, jtrace, jskew, jreport),
        "torch": (tevents, ttrace, tskew, treport)}
WALL_AHEAD = {0: 1_000_000.0, 1: 1_000_002.5}


class Clock:
    """One monotonic clock both ranks read (10 ms a tick), and per-rank
    wall clocks offset from it with a small deterministic jitter."""

    def __init__(self):
        self.t = 100.0
        self.n = 0

    def mono(self):
        self.t += 0.01
        return self.t

    def wall(self, rank):
        def read():
            self.n += 1
            return self.t + WALL_AHEAD[rank] + 1e-5 * (self.n % 3)
        return read


def write_run(side, directory, alarm=True):
    """The scripted run on one package's bus and tracer."""
    events, trace, skew, _ = PKGS[side]
    clock = Clock()
    b0 = events.EventBus(directory, rank=0, clock=clock.mono,
                         wall=clock.wall(0))
    b1 = events.EventBus(directory, rank=1, clock=clock.mono,
                         wall=clock.wall(1))
    t0, t1 = trace.Tracer(b0), trace.Tracer(b1)
    skew.stamp(b0, source="worker_start")
    skew.stamp(b1, source="worker_start")
    b0.emit("run_start", config="ppo-mlp-synth64", iterations=3)
    for i in range(3):
        with t0.span("iteration", iteration=i):
            with t0.span("rollout"):
                with t0.span("step", n=8):
                    pass
            with t0.span("update"):
                pass
        b0.emit("iteration", iteration=i,
                phases={"rollout": 0.5 + 0.1 * i, "update": 0.25},
                steps_per_sec=1000.0 + i, wall_s=0.75 + i)
        skew.stamp(b1, source="heartbeat", step=i)
        b1.emit("worker_step", step=i)
    actor, learner = t0.lane("actor-lane"), t0.lane("learner-lane")
    with actor.span("actor"):
        with learner.span("learner"):
            pass
        b0.emit("async_tick")
    with learner.span("learner"):
        pass
    with actor.span("actor"):
        pass
    b0.emit("fault", fault="nan-grads", iteration=1)
    b0.emit("rollback", reason="nan", to_step=2)
    b0.emit("ckpt_restore", step=2)
    b1.emit("rank_failure", exit_code=137)
    for regime, sched, jct, done, deg in (("storm", "policy", 1234.5, 0.9,
                                           1.25),
                                          ("none", "fifo", None, None,
                                           None)):
        b0.emit("env_fault", regime=regime, scheduler=sched, avg_jct=jct,
                completion=done, degradation=deg, fault_n_drains=3,
                chaos_seed=0)
    for kind in ("serve_fault", "engine_eject", "engine_readmit",
                 "serve_retry", "slo_burn_alert", "slo_burn_clear"):
        b0.emit(kind, engine=1, spec="availability")
    b0.emit("compile", bucket=8)
    if alarm:
        b0.emit("recompile", reason="new bucket", bucket=16)
    t0.instant("enqueue", stall=0, req_id=7)
    t0.instant("served", bucket=2, req_ids=[5, 7], wait_ms=[0.5, 0.25],
               lat_ms=[1.5, 1.25])
    t0.instant("shed", reason="admission", req_id=8)
    t0.instant("dispatch_failed", req_ids=[9], error="RuntimeError")
    # torn spans: an inner span closed by its outer's end, and a span a
    # crash left open on rank 1
    t0._begin("outer", {})
    t0._begin("inner", {"k": 1})
    t0._end("outer")
    t1._begin("checkpoint", {"step": 3})
    b1.emit("after_crash")
    b0.close()
    b1.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for side in PKGS:
        for alarm in (True, False):
            d = tmp_path_factory.mktemp(f"{side}-{alarm}")
            write_run(side, str(d), alarm=alarm)
            out[side, alarm] = str(d)
    return out


def test_both_buses_write_the_same_streams(runs):
    for alarm in (True, False):
        jd, td = runs["jax", alarm], runs["torch", alarm]
        assert sorted(os.listdir(jd)) == sorted(os.listdir(td)) == [
            "events.rank0.jsonl", "events.rank1.jsonl"]
        for name in os.listdir(jd):
            with open(os.path.join(jd, name), "rb") as a, \
                    open(os.path.join(td, name), "rb") as b:
                assert a.read() == b.read()
        # each package reads the other's streams
        assert tevents.merge_dir(jd) == jevents.merge_dir(td) == \
            jevents.merge_dir(jd)


@pytest.mark.parametrize("corrected", [False, True])
def test_the_readers_agree_exactly(runs, corrected):
    events = jevents.merge_dir(runs["torch", True])
    got = {}
    for side, (_, trace, skew, report) in PKGS.items():
        ev, info = (skew.correct_events(events) if corrected
                    else (events, {"applied": False}))
        rep = report.build_report(ev)
        rep["skew"] = info
        got[side] = {
            "offsets": {r: dataclasses.asdict(s)
                        for r, s in skew.learn_offsets(events).items()},
            "corrected": skew.correct_events(events),
            "report": rep, "text": report.format_report(rep),
            "chrome": trace.to_chrome_trace(ev),
            "tree": trace.build_span_tree(ev),
            "overlap": trace.async_overlap_summary(ev)}
    assert got["torch"] == got["jax"]
    g = got["torch"]
    assert g["overlap"] is not None and g["report"]["torn_spans"] == 2
    assert g["report"]["alarms"]["recompile"] == 1
    assert len(g["report"]["chaos"]) == 2 and len(g["report"]["fleet"]) == 6
    assert g["offsets"][1]["dedicated"] and g["offsets"][1]["n_samples"] == 4
    info = g["corrected"][1]
    assert info["applied"] and info["ranks"]["1"]["shift_s"] == \
        pytest.approx(2.5, abs=1e-4)
    if corrected:
        assert "clock skew: timeline rewritten" in g["text"]


def _main(side, argv, capsys):
    rc = PKGS[side][3].main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_the_cli_is_jaxs(runs, tmp_path, capsys):
    d = runs["torch", True]
    for argv in ([d], [d, "--json"], [d, "--json", "--no-skew-correct"],
                 [d, "--request", "7"], [d, "--request", "0x7", "--json"],
                 [d, "--request", "9"], [d, "--request", "8"],
                 [d, "--request", "12345"], [d, "--request", "xx"],
                 [d, "--strict-alarms"], [runs["jax", False],
                                          "--strict-alarms"]):
        assert _main("torch", argv, capsys) == _main("jax", argv, capsys)
    assert _main("torch", [d, "--request", "7"], capsys)[0] == 0
    assert _main("torch", [d, "--request", "12345"], capsys)[0] == 1
    assert _main("torch", [d, "--request", "xx"], capsys)[0] == 2
    assert _main("torch", [d, "--strict-alarms"], capsys)[0] == 1
    assert _main("torch", [runs["torch", False], "--strict-alarms"],
                 capsys)[0] == 0
    with pytest.raises(SystemExit) as e:
        treport.main([d, "--no-such-flag"])
    assert e.value.code == 2
    # the timeline and the Chrome trace written to files
    files = {}
    for side in PKGS:
        out, tr = tmp_path / f"{side}.jsonl", tmp_path / f"{side}.json"
        assert _main(side, [d, "--out", str(out), "--trace-out", str(tr)],
                     capsys)[0] == 0
        files[side] = (out.read_text(), json.loads(tr.read_text()))
    assert files["torch"] == files["jax"]
    assert files["torch"][1]["traceEvents"]


def test_the_cli_fails_loudly_without_events(tmp_path, capsys):
    assert _main("torch", [str(tmp_path / "missing")], capsys)[0] == 1
    empty = tmp_path / "empty"
    empty.mkdir()
    assert _main("torch", [str(empty)], capsys)[0] == 1
    (empty / "events.rank0.jsonl").write_text("")
    rc, _, err = _main("torch", [str(empty)], capsys)
    assert rc == 1 and "no decodable events" in err


def test_the_flight_log_join_is_refused_naming_its_item(runs, tmp_path,
                                                      capsys):
    """Once refused, now ported: the request's flight-log row and the
    ledger verdicts covering it, as JAX's report joins them."""
    from rlgpuschedule_tpu.flywheel import canary as jcanary
    from rlgpuschedule_tpu_torch.flywheel import (FlightLogWriter,
                                                  PromotionLedger)
    d = runs["torch", True]
    rng = np.random.default_rng(2)
    flogs = {}
    for side in ("jax", "torch"):
        f = str(tmp_path / side)
        with FlightLogWriter(f, capacity=4) as w:
            for lo in (0, 6):
                rid = np.arange(lo, lo + 6, dtype=np.int64) + 3  # ids 3-14
                w.append_batch(rng.random((6, 2), np.float32),
                               np.ones((6, 3), bool),
                               np.zeros(6, np.int32),
                               np.zeros(6, np.float32),
                               np.zeros(6, np.float32),
                               np.zeros(6, np.int32),
                               np.arange(6, dtype=np.int8) % 3, req_id=rid)
        led = (jcanary.PromotionLedger(f) if side == "jax"
               else PromotionLedger(f))
        for action, rows in (("blocked", 12), ("promote", 3),
                             ("rollback", 12)):
            led.append({"action": action, "verdict": "promote",
                        "candidate": "c", "window_rows": rows})
        flogs[side] = f
    for rid in ("7", "0x9", "4242", "14"):
        for extra in ([], ["--json"]):
            for f in flogs.values():
                argv = [d, "--request", rid, "--flight-log", f] + extra
                assert _main("torch", argv, capsys) == \
                    _main("jax", argv, capsys)
    events = jevents.merge_dir(d)
    got = treport.build_request_report(events, 7, flight_dir=flogs["jax"])
    assert got == jreport.build_request_report(events, 7,
                                               flight_dir=flogs["jax"])
    assert got["flight"]["shard_seq"] == 1 and got["flight"]["row"] == 0
    assert got["flight"]["outcome_name"] == "met"
    assert [v["action"] for v in got["verdicts"]] == ["blocked", "rollback"]
    # an id only the log holds is found there; one nowhere is not
    only = treport.build_request_report(events, 14,
                                        flight_dir=flogs["torch"])
    assert only["found"] and not only["stages"]
    assert not treport.build_request_report(events, 4242, flogs["torch"])[
        "found"]
    assert "logged: shard 000001 row 0" in treport.format_request_report(
        got)


class SlowHostEngine:
    """Argmax over the row after a real sleep per dispatch."""

    max_bucket = 1

    def __init__(self, cost_s):
        self.cost_s = cost_s

    def bucket_for(self, n):
        return next_bucket(n, self.max_bucket)

    def decide(self, obs, mask, stall=None):
        time.sleep(self.cost_s)
        return (np.argmax(np.asarray(obs), axis=-1).astype(np.int32),
                self.bucket_for(np.asarray(obs).shape[0]))


def _post(port, obs, mask, rid, deadline_ms=None):
    body = obs.tobytes() + mask.tobytes()
    head = ["POST /v1/decide HTTP/1.1", "Host: t",
            f"Content-Length: {len(body)}", f"X-Request-Id: {rid}",
            "Connection: close"]
    if deadline_ms is not None:
        head.append(f"X-Deadline-Ms: {deadline_ms}")
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        return s.makefile("rb").readline().split()[1]


def test_a_front_door_requests_timeline_from_the_ports_stream(tmp_path,
                                                              capsys):
    d = str(tmp_path / "serve")
    bus = tevents.EventBus(d, rank=0, name="serve")
    server = PolicyServer(SlowHostEngine(0.3), registry=Registry(),
                          tracer=ttrace.Tracer(bus), bus=bus)
    server.start()
    obs = np.arange(6, dtype=np.float32)
    mask = np.ones(9, bool)
    handle = start_frontend(server, obs, mask)
    statuses = {}
    try:
        # 301 holds the dispatcher 0.3 s; 302 (50 ms deadline, admitted
        # while the estimator is cold) expires in the queue behind it
        first = threading.Thread(target=lambda: statuses.setdefault(
            301, _post(handle.port, obs, mask, 301)))
        first.start()
        time.sleep(0.1)
        statuses[302] = _post(handle.port, obs, mask, 302, deadline_ms=50)
        first.join(timeout=30)
        statuses[303] = _post(handle.port, obs, mask, 303)
        with socket.create_connection(("127.0.0.1", handle.port),
                                      timeout=30) as s:
            s.sendall(wire.pack_request(obs, mask, req_id=304))
            assert wire.recv_frame(s)[5] == 304
    finally:
        handle.close()
        bus.close()
    assert statuses == {301: b"200", 302: b"503", 303: b"200"}
    events = tevents.merge_dir(d)
    for rid, want in ((301, ["enqueue", "served"]),
                      (302, ["enqueue", "shed"]),
                      (303, ["enqueue", "served"]),
                      (304, ["enqueue", "served"])):
        rep = treport.build_request_report(events, rid)
        assert rep == jreport.build_request_report(events, rid)
        assert rep["found"] and [s["stage"] for s in rep["stages"]] == want
        served = rep["stages"][-1]
        if want[-1] == "served":
            assert served["batch_rows"] == 1 and served["latency_ms"] > 0
        else:
            assert served["reason"] == "expired"
    rc, out, _ = _main("torch", [d, "--request", str(302), "--json"], capsys)
    assert rc == 0 and json.loads(out)["stages"][1]["stage"] == "shed"
    assert _main("torch", [d, "--strict-alarms"], capsys)[0] == 0
