"""The port's network front door (``rlgpuschedule_tpu_torch/serve/
frontend.py``) against the JAX package's, and on its own.

- Parity: one scripted exchange runs through JAX's ``start_frontend``
  over JAX's ``PolicyServer`` and through the port's over the port's,
  both over the same host-only engine (argmax over the row, no compile):
  decide, healthz, an unknown route, a wrong-length body, bad deadlines,
  bad, overflowing and hex ``X-Request-Id`` s, a pipelined keep-alive
  run, a malformed request line, a framed run (descriptor mismatch, a
  v1 frame, an overflowing id, a wrong-length body, a wrong kind) and a
  shed on each dialect with the service time pinned on both servers.
  Both give the same status codes, header names, JSON payloads (less
  the measured latency), actions, echoed and minted ids, Retry-After
  values, and frame kinds, reasons and ids.
- The port alone: backpressure at a small high-water mark, the drain
  contract on this Python (an idle keep-alive connection, a framed one,
  a mid-stream SIGTERM and a connection still in the accept queue, each
  within a bounded wait), ``queue_depth()`` on both data planes against
  JAX's, the Retry-After clamp, a request past the timeout (504 and
  ``KIND_ERR timeout``, as JAX's), and the refusal of a tree-shaped
  row.
- A real policy: config 1 cut to 4 x 4 GPUs, JAX's weights converted,
  the same rows through both front doors over HTTP and framed: equal
  actions.
"""
import contextlib
import dataclasses
import json
import signal
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu.obs import Registry as JRegistry
from rlgpuschedule_tpu.serve import PolicyServer as JServer
from rlgpuschedule_tpu.serve import start_frontend as jstart_frontend
from rlgpuschedule_tpu.serve import wire as jwire
from rlgpuschedule_tpu.serve.engine import InferenceEngine as JEngine
from rlgpuschedule_tpu.serve.frontend import ServeFrontend as JFrontend
from rlgpuschedule_tpu_torch import configs as tconfigs
from rlgpuschedule_tpu_torch.experiment import build_env_params as tbuild
from rlgpuschedule_tpu_torch.models import make_policy, params_from_jax
from rlgpuschedule_tpu_torch.obs import Registry
from rlgpuschedule_tpu_torch.serve import (InferenceEngine, PolicyServer,
                                           ServerClosedError, next_bucket,
                                           start_frontend, wire)
from rlgpuschedule_tpu_torch.serve.batching import DeadlineSheddedError
from rlgpuschedule_tpu_torch.serve.frontend import (DECIDE_PATH,
                                                    HEALTH_PATH,
                                                    RETRY_AFTER_MAX_S,
                                                    RETRY_AFTER_MIN_S,
                                                    ServeFrontend)
from torch_jax_builds import jax_view

OBS_D, ACT_D = 6, 9
BOUND_S = 10.0          # every drain-contract wait is held to this


class HostEngine:
    """Host-only engine: argmax over the observation row, with an
    optional real sleep per dispatch."""

    def __init__(self, max_bucket=8, cost_s=0.0):
        self.max_bucket = max_bucket
        self.cost_s = cost_s

    def bucket_for(self, n):
        return next_bucket(n, self.max_bucket)

    def decide(self, obs, mask, stall=None):
        if self.cost_s:
            time.sleep(self.cost_s)
        n = int(np.asarray(obs).shape[0])
        return (np.argmax(np.asarray(obs), axis=-1).astype(np.int32),
                self.bucket_for(n))


SIDES = {"jax": (JServer, JRegistry, jstart_frontend, jwire),
         "torch": (PolicyServer, Registry, start_frontend, wire)}


def example(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(OBS_D).astype(np.float32),
            np.ones(ACT_D, bool))


@contextlib.contextmanager
def stack(side="torch", cost_s=0.0, max_bucket=8, data_plane="arena",
          **fe_kw):
    server_cls, reg_cls, start, _ = SIDES[side]
    reg = reg_cls()
    server = server_cls(HostEngine(max_bucket, cost_s), registry=reg,
                        data_plane=data_plane)
    server.start()
    obs, mask = example()
    handle = start(server, obs, mask, port=0, **fe_kw)
    try:
        yield handle, server, reg, obs, mask
    finally:
        handle.close()


def raw_request(obs, mask, headers=(), path=DECIDE_PATH, body=None):
    body = obs.tobytes() + mask.tobytes() if body is None else body
    head = [f"POST {path} HTTP/1.1", "Host: test",
            f"Content-Length: {len(body)}", *headers]
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def read_response(f):
    """One Content-Length-framed HTTP response: (status, headers,
    payload); EOFError if the connection closed first."""
    status_line = f.readline()
    if not status_line:
        raise EOFError("connection closed before a status line")
    status = int(status_line.split()[1])
    headers = {}
    while True:
        line = f.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    body = f.read(int(headers.get("content-length", "0")))
    return status, headers, (json.loads(body) if body else None)


def onehot(i, d=OBS_D):
    x = np.zeros(d, np.float32)
    x[i] = 1.0
    return x


@contextlib.contextmanager
def connect(port):
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s, \
            s.makefile("rb") as f:
        yield s, f


def _http_record(resp):
    status, headers, payload = resp
    payload = dict(payload or {})
    payload.pop("latency_ms", None)         # a measured time
    return (status, sorted(headers),
            {k: headers[k] for k in ("connection", "content-type",
                                     "retry-after") if k in headers},
            payload)


def _frame_record(frame):
    kind, header, body, meta64, meta32, rid = frame
    if kind == wire.KIND_RESP:       # meta64 is the measured latency
        return (kind, header, body, meta32, rid)
    return (kind, header, json.loads(body), meta64, meta32, rid)


def exchange(side, handle, server, obs, mask, monkeypatch):
    """The scripted exchange: a list of normalized records."""
    _, _, _, w = SIDES[side]
    rec = []
    body = obs.tobytes() + mask.tobytes()
    with connect(handle.port) as (s, f):
        s.sendall(raw_request(obs, mask, ("X-Request-Id: 11",)))
        rec.append(_http_record(read_response(f)))
        s.sendall(raw_request(obs, mask))                  # minted id
        rec.append(_http_record(read_response(f)))
        s.sendall(b"GET /healthz HTTP/1.1\r\nHost: t\r\n\r\n")
        rec.append(_http_record(read_response(f)))
        s.sendall(raw_request(obs, mask, path="/nope", body=b""))
        rec.append(_http_record(read_response(f)))
        s.sendall(raw_request(obs, mask, body=b"x" * 3))
        rec.append(_http_record(read_response(f)))
        for bad in ("junk", "nan", "inf", "-5", "0"):
            s.sendall(raw_request(obs, mask, (f"X-Deadline-Ms: {bad}",)))
            rec.append(_http_record(read_response(f)))
        for rid in ("junk", "-3", str(1 << 63), "0x10", str((1 << 63) - 1)):
            s.sendall(raw_request(obs, mask, (f"X-Request-Id: {rid}",)))
            rec.append(_http_record(read_response(f)))
    # a pipelined keep-alive run, the last request asking to close
    burst = b"".join(
        raw_request(onehot(i % OBS_D), mask,
                    ("Connection: close",) if i == 5 else ())
        for i in range(6))
    with connect(handle.port) as (s, f):
        s.sendall(burst)
        rec.extend(_http_record(read_response(f)) for _ in range(6))
        rec.append(("eof", f.readline()))
    with connect(handle.port) as (s, f):
        s.sendall(b"NONSENSE\r\n\r\n")
        rec.append(_http_record(read_response(f)))
        rec.append(("eof", f.readline()))
    # the framed dialect on one connection
    desc = w.descriptor(obs) + b"|" + w.descriptor(mask)
    with socket.create_connection(("127.0.0.1", handle.port),
                                  timeout=30) as s:
        for frame in (
                w.pack_request(obs, mask, req_id=0x5150),
                w.pack_request(onehot(3), mask),           # minted id
                w.pack_frame(w.KIND_REQ, b"float64:(6,)|bool:(9,)", body,
                             req_id=0x77),
                w.PREFIX_V1.pack(w.MAGIC, 1, w.KIND_REQ, len(desc),
                                 len(body), 0, 0) + desc + body,
                w.pack_request(obs, mask, req_id=(1 << 63) + 1),
                w.pack_frame(w.KIND_REQ, desc, body[:-1], req_id=5),
                w.pack_request(onehot(2), mask, stall=3, req_id=6)):
            s.sendall(frame)
            rec.append(_frame_record(w.recv_frame(s)))
        s.sendall(w.pack_response(np.int32(0), 0.0, req_id=9))
        rec.append(_frame_record(w.recv_frame(s)))
        with pytest.raises(EOFError):
            w.recv_frame(s)                    # wrong kind: hung up
    # a shed on each dialect, the service time pinned on the server
    monkeypatch.setattr(server._service_time, "value", 5.0)
    monkeypatch.setattr(server, "service_time_s", lambda: 5.0)
    with connect(handle.port) as (s, f):
        s.sendall(raw_request(obs, mask, ("X-Deadline-Ms: 1",
                                          "X-Request-Id: 314159")))
        rec.append(_http_record(read_response(f)))
    with socket.create_connection(("127.0.0.1", handle.port),
                                  timeout=30) as s:
        s.sendall(w.pack_request(obs, mask, deadline_s=0.001, req_id=42))
        rec.append(_frame_record(w.recv_frame(s)))
    return rec


def test_the_scripted_exchange_matches_jaxs_front_door(monkeypatch):
    out = {}
    for side in SIDES:
        with stack(side) as (handle, server, reg, obs, mask):
            out[side] = exchange(side, handle, server, obs, mask,
                                 monkeypatch)
            out[side].append(("counters", {
                n: reg.counter(n).value for n in (
                    "serve_frontend_requests_total",
                    "serve_frontend_shed_total",
                    "serve_frontend_bad_requests_total",
                    "serve_frontend_closed_total",
                    "serve_requests_total", "serve_shed_total")}))
        monkeypatch.undo()
    assert out["torch"] == out["jax"]
    rec = out["torch"]
    # the script reached what it meant to: a shed with the pinned hint
    # on both dialects, minted ids, and the pipelined actions in order
    http_shed, frame_shed = rec[-3], rec[-2]
    assert http_shed[0] == 503 and http_shed[2]["retry-after"] == "9.999"
    assert frame_shed[1] == b"shed:admission"
    assert frame_shed[3] == pytest.approx(9.999e6, abs=1)
    assert rec[1][3]["request_id"] > 0 and rec[0][3]["request_id"] == 11
    assert [r[3]["action"] for r in rec[15:21]] == list(range(6))


class TestBackpressure:
    def test_high_water_pauses_reads_and_every_request_resolves(self):
        with stack(cost_s=0.02, max_bucket=1, high_water=2,
                   low_water=1) as (handle, server, reg, obs, mask):
            body = obs.tobytes() + mask.tobytes()
            results = []

            def one():
                req = urllib.request.Request(handle.url + DECIDE_PATH,
                                             data=body, method="POST")
                with urllib.request.urlopen(req, timeout=60) as r:
                    results.append(r.status)

            threads = [threading.Thread(target=one) for _ in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert results == [200] * 12
            assert reg.counter(
                "serve_frontend_backpressure_pauses_total").value >= 1
            submitted = reg.counter("serve_requests_total").value
            shed = reg.counter("serve_shed_total").value
            assert submitted == 12
            assert submitted == server.slo_snapshot()["requests"] + shed


def _closed_within(f, bound=BOUND_S):
    """The server closes the connection within ``bound``: an EOF."""
    t0 = time.monotonic()
    assert f.readline() == b""
    return time.monotonic() - t0 <= bound


class TestDrain:
    """The README's drain contract on this Python, every wait bounded."""

    def test_idle_keep_alive_connections_get_a_typed_refusal_or_eof(self):
        with stack() as (handle, server, reg, obs, mask):
            with connect(handle.port) as (s1, f1), \
                    connect(handle.port) as (s2, f2):
                for s, f in ((s1, f1), (s2, f2)):
                    s.sendall(raw_request(obs, mask))
                    assert read_response(f)[0] == 200
                # two kept-alive connections idle: the drain returns
                t0 = time.monotonic()
                handle.drain(timeout=BOUND_S)
                assert time.monotonic() - t0 < BOUND_S
                assert server.closed
                with pytest.raises(ServerClosedError):
                    server.submit(obs, mask)
                # one sends again: the typed 503, close, then EOF
                s1.sendall(raw_request(obs, mask))
                status, headers, payload = read_response(f1)
                assert (status, payload["error"], headers["connection"]) \
                    == (503, "closed", "close")
                assert _closed_within(f1)
                # the other never sends: the linger closes it
                s2.settimeout(BOUND_S)
                assert _closed_within(f2)
            assert reg.counter("serve_frontend_closed_total").value == 1
            deadline = time.monotonic() + BOUND_S
            while handle.frontend._conns:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            t0 = time.monotonic()
            handle.drain()                          # idempotent
            assert time.monotonic() - t0 < BOUND_S

    def test_framed_drain_is_typed_and_terminal(self):
        with stack() as (handle, server, reg, obs, mask):
            with socket.create_connection(("127.0.0.1", handle.port),
                                          timeout=30) as s:
                s.sendall(wire.pack_request(obs, mask))
                assert wire.recv_frame(s)[0] == wire.KIND_RESP
                handle.drain(timeout=BOUND_S)
                s.sendall(wire.pack_request(obs, mask, req_id=3))
                kind, header, _, _, _, rid = wire.recv_frame(s)
                assert (kind, header, rid) == (wire.KIND_ERR, b"closed", 3)
                with pytest.raises(EOFError):
                    wire.recv_frame(s)

    def test_mid_stream_sigterm_drains_typed_never_hangs(self):
        assert threading.current_thread() is threading.main_thread()
        prev = signal.getsignal(signal.SIGTERM)
        try:
            with stack() as (handle, server, reg, obs, mask):
                handle.install_sigterm()
                with connect(handle.port) as (s, f):
                    s.sendall(raw_request(obs, mask))
                    assert read_response(f)[0] == 200   # mid-stream now
                    signal.raise_signal(signal.SIGTERM)
                    deadline = time.monotonic() + BOUND_S
                    while not server.closed:
                        assert time.monotonic() < deadline, \
                            "the drain never completed"
                        time.sleep(0.01)
                    s.sendall(raw_request(obs, mask))
                    status, headers, payload = read_response(f)
                    assert (status, payload["error"],
                            headers["connection"]) == (503, "closed",
                                                       "close")
                    assert _closed_within(f)
                assert reg.counter(
                    "serve_frontend_closed_total").value == 1
            assert signal.getsignal(signal.SIGTERM) is prev
        finally:
            signal.signal(signal.SIGTERM, prev)

    def test_a_connection_in_the_accept_queue_is_refused_never_hangs(self):
        # park the event loop so the connection is still un-accepted
        # when the drain runs
        with stack() as (handle, server, reg, obs, mask):
            handle._loop.call_soon_threadsafe(time.sleep, 0.3)
            time.sleep(0.05)                  # the park is now running
            with connect(handle.port) as (c, f):
                t0 = time.monotonic()
                handle.drain(timeout=BOUND_S)
                assert time.monotonic() - t0 < BOUND_S
                c.sendall(raw_request(obs, mask))
                status, headers, payload = read_response(f)
                assert (status, payload["error"], headers["connection"]) \
                    == (503, "closed", "close")
                assert _closed_within(f)
            with pytest.raises(OSError):
                socket.create_connection(("127.0.0.1", handle.port),
                                         timeout=5)

    def test_close_returns_with_a_silent_client_open(self):
        """A client that connected and never sent a byte holds neither
        the drain nor the close."""
        with stack() as (handle, server, reg, obs, mask):
            with connect(handle.port) as (c, f):
                time.sleep(0.05)
                t0 = time.monotonic()
                handle.close()
                assert time.monotonic() - t0 < BOUND_S
                c.settimeout(BOUND_S)
                assert _closed_within(f)


@pytest.mark.parametrize("plane", ["arena", "legacy"])
def test_queue_depth_on_both_data_planes_matches_jax(plane):
    obs, mask = example()
    depths = {}
    for side, (server_cls, reg_cls, _, _) in SIDES.items():
        server = server_cls(HostEngine(4), registry=reg_cls(),
                            data_plane=plane, example_obs=obs,
                            example_mask=mask)
        seen = [server.queue_depth()]
        for _ in range(6):
            server.submit(obs, mask)
            seen.append(server.queue_depth())
        while server.pump():
            seen.append(server.queue_depth())
        depths[side] = seen
        server.close()
    assert depths["torch"] == depths["jax"] == [0, 1, 2, 3, 4, 5, 6, 2, 0]


def test_retry_after_is_jaxs_and_clamped(monkeypatch):
    obs, mask = example()
    fes = {"jax": JFrontend(JServer(HostEngine(), registry=JRegistry()),
                            obs, mask),
           "torch": ServeFrontend(PolicyServer(HostEngine(),
                                               registry=Registry()),
                                  obs, mask)}
    for svc in (1e9, 1e-9, None, 0.25):
        for predicted in (None, 0.101, 1e6):
            got = {}
            for side, fe in fes.items():
                monkeypatch.setattr(fe.server, "service_time_s",
                                    lambda svc=svc: svc)
                got[side] = fe._retry_after_s(DeadlineSheddedError(
                    "admission", deadline_s=0.001, waited_s=0.0,
                    predicted_wait_s=predicted))
            assert got["torch"] == got["jax"]
            assert RETRY_AFTER_MIN_S <= got["torch"] <= RETRY_AFTER_MAX_S


def test_a_request_past_the_timeout_gets_jaxs_504_and_frame(monkeypatch):
    from rlgpuschedule_tpu_torch.serve import frontend as tfrontend
    monkeypatch.setattr(tfrontend, "REQUEST_TIMEOUT_S", 0.2)
    obs, mask = example()
    out = {}
    for side, (server_cls, reg_cls, start, w) in SIDES.items():
        # no dispatcher: the request waits in the queue past the timeout
        server = server_cls(HostEngine(), registry=reg_cls())
        kw = {"request_timeout_s": 0.2} if side == "jax" else {}
        handle = start(server, obs, mask, port=0, **kw)
        rec = []
        try:
            with connect(handle.port) as (s, f):
                s.sendall(raw_request(obs, mask, ("X-Request-Id: 7",)))
                rec.append(_http_record(read_response(f)))
            with socket.create_connection(("127.0.0.1", handle.port),
                                          timeout=30) as s:
                s.sendall(w.pack_request(obs, mask, req_id=8))
                rec.append(_frame_record(w.recv_frame(s)))
        finally:
            handle.close()
        out[side] = rec
    assert out["torch"] == out["jax"]
    http, frame = out["torch"]
    assert http[0] == 504
    assert http[3] == {"error": "timeout", "timeout_s": 0.2, "request_id": 7}
    assert frame[0] == wire.KIND_ERR and frame[1] == b"timeout"
    assert frame[2] == {"timeout_s": 0.2} and frame[-1] == 8


def test_a_tree_shaped_row_is_refused():
    obs, mask = example()
    server = PolicyServer(HostEngine(), registry=Registry())
    for o, m in (({"a": obs}, mask), (obs, (mask,))):
        with pytest.raises(TypeError, match="one-array rows"):
            ServeFrontend(server, o, m)


SMALL = dict(n_envs=2, window_jobs=12, horizon=96, n_nodes=4,
             gpus_per_node=4, queue_len=4)


def test_a_real_policy_serves_jaxs_actions_through_both_front_doors():
    """Config 1 cut to 4 x 4 GPUs: JAX's seeded weights, converted for
    the port; 24 seeded rows over HTTP and 24 over framed, one at a
    time (so every dispatch is bucket 1, one JAX program), through each
    package's front door over its own engine: equal actions."""
    jcfg = dataclasses.replace(jconfigs.CONFIGS["ppo-mlp-synth64"], **SMALL)
    tcfg = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"], **SMALL)
    view = jax_view(jcfg)
    tp = tbuild(tcfg)
    policy = make_policy("flat", tp.n_actions, tp.obs_shape(),
                         dtype=torch.float32, device="cpu")
    policy.load_state_dict(params_from_jax(view.train_state.params))
    rng = np.random.default_rng(12)
    obs = rng.standard_normal((48,) + tp.obs_shape()).astype(np.float32)
    mask = rng.random((48, tp.n_actions)) < 0.6
    mask[:, -1] = True
    engines = {
        "jax": JEngine(view.apply_fn, view.train_state.params,
                       view.env_params, max_bucket=8, strict=False),
        "torch": InferenceEngine(policy, max_bucket=8, device="cpu",
                                 env_params=tp)}
    actions = {}
    for side, engine in engines.items():
        server_cls, reg_cls, start, w = SIDES[side]
        server = server_cls(engine, registry=reg_cls())
        server.start()
        handle = start(server, obs[0], mask[0], port=0)
        got = []
        try:
            with connect(handle.port) as (s, f):
                for i in range(24):
                    s.sendall(raw_request(obs[i], mask[i],
                                          (f"X-Request-Id: {i + 1}",)))
                    status, _, payload = read_response(f)
                    assert status == 200 and payload["request_id"] == i + 1
                    got.append(payload["action"])
            with socket.create_connection(("127.0.0.1", handle.port),
                                          timeout=30) as s:
                for i in range(24, 48):
                    s.sendall(w.pack_request(obs[i], mask[i]))
                    kind, header, body, _, _, _ = w.recv_frame(s)
                    assert kind == w.KIND_RESP
                    got.append(int(w.unpack_action(header, body).item()))
        finally:
            handle.close()
        actions[side] = got
    assert actions["torch"] == actions["jax"]
    assert all(mask[i, a] for i, a in enumerate(actions["torch"]))
