"""The network front door: asyncio HTTP and framed sockets in front of the
policy server.

The port's counterpart of the JAX package's ``serve/frontend.py``: the
same routes, headers, status codes, JSON keys and frames, so a client
cannot tell the two packages' front doors apart. It is the thinnest wire
layer over :class:`~.batching.PolicyServer` (one engine or an
:class:`~.router.EngineRouter`), built so that every failure the serving
tier can produce has ONE well-defined shape on the wire:

- ``POST /v1/decide`` carries one request's observation and action-mask
  bytes raw in the body (shapes and dtypes fixed at construction from an
  example request). The body is read once off the socket and viewed
  **zero-copy** with ``np.frombuffer``; the first copy of a request's
  bytes is its arena slot write inside ``submit``, exactly as for an
  in-process submit.
- ``X-Deadline-Ms`` carries the client's latency SLO into admission and
  shedding. A shed request gets **503** with a ``Retry-After`` priced
  from the server's LEARNED service time (plus the predicted excess
  wait of an admission shed), clamped to
  [``RETRY_AFTER_MIN_S``, ``RETRY_AFTER_MAX_S``]. ``X-Request-Id``
  carries the 64-bit request id (minted when absent or 0; refused with
  400 at or above 2**63, the causality lane being int64), and every
  reply shape echoes it.
- **Backpressure is connection-level**: past a queue-depth high-water
  mark the listener stops reading sockets (an ``asyncio.Event`` gate
  ahead of every read) and resumes at the low-water mark; unread bytes
  pile up in kernel buffers and TCP pushes back on the client.
- Connections are **persistent**: HTTP/1.1 keep-alive with pipelining
  (``Connection: close`` from either side ends one), and a connection
  whose first 4 bytes are :data:`~.wire.MAGIC` is **framed** for its
  whole life (:mod:`.wire`, v2 and v1 prefixes).
- **Graceful drain** (SIGTERM through :meth:`FrontendHandle.
  install_sigterm`, or :meth:`ServeFrontend.drain`): stop accepting,
  hand every connection still in the kernel's accept queue to the normal
  handler, let every in-flight request resolve, then close the policy
  server, so a late ``submit`` raises the typed
  :class:`~.batching.ServerClosedError`. A connection that sends a
  request after the drain gets the typed 503 ``closed`` (or
  ``KIND_ERR closed``) and ``Connection: close``; every connection still
  open ``DRAIN_LINGER_S`` after the drain is closed, which the client
  reads as an EOF. No future and no client read hangs.

**Python 3.12.** The drain never awaits ``asyncio.Server.wait_closed()``:
since 3.12.1 it also waits for every connection the server still holds,
so one idle keep-alive client would hold the drain until it left (the
JAX package's drain, written against 3.10, does await it).

**No CUDA on the loop thread.** While any dispatcher serves, the port's
sync guard (``torch.cuda.set_sync_debug_mode("error")``) is on for the
whole process. The event-loop thread therefore touches only numpy,
sockets and ``concurrent.futures``: the request body is viewed with
``np.frombuffer`` (read-only) and copied by numpy into the arena slot.

One-array rows only: a tree-shaped example observation (the
hierarchical config's dict) is refused with ``TypeError``, as neither
package's front door serves it. The listener is stdlib only
(``asyncio.start_server`` and a hand-rolled HTTP/1.1).
"""
from __future__ import annotations

import asyncio
import json
import math
import signal
import socket
import threading
from concurrent.futures import Future
from typing import Any

import numpy as np

from . import wire
from .batching import DeadlineSheddedError, PolicyServer, ServerClosedError

DECIDE_PATH = "/v1/decide"
HEALTH_PATH = "/healthz"

# Retry-After sanity band: below 10ms a retry hint is noise (the
# client's round trip dwarfs it), above 30s it reads as an outage, and a
# poisoned or stale estimator must be able to advertise neither
RETRY_AFTER_MIN_S = 0.01
RETRY_AFTER_MAX_S = 30.0

# how often the backpressure gate samples the server's queue depth
POLL_S = 0.005

# how long one request may wait for its action before it is answered
# 504 / ``KIND_ERR timeout`` (its future is cancelled)
REQUEST_TIMEOUT_S = 120.0

# how long a drain waits for in-flight requests before it closes the
# server all the same and raises TimeoutError
DRAIN_GRACE_S = 30.0

# how long after a drain an idle connection may still send (and get the
# typed refusal) before it is closed: long enough for a client that
# pipelined into the drain to read its answer, short enough that no
# client waits on a dead server
DRAIN_LINGER_S = 2.0


def _response(status: str, payload: dict,
              extra_headers: "tuple[str, ...]" = (),
              close: bool = False) -> bytes:
    body = json.dumps(payload).encode()
    head = [f"HTTP/1.1 {status}",
            "Content-Type: application/json",
            f"Content-Length: {len(body)}",
            "Connection: close" if close else "Connection: keep-alive",
            *extra_headers]
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


class _BadRequest(Exception):
    """Malformed wire input; maps to 400 without killing the connection."""


class ServeFrontend:
    """One asyncio listener (HTTP and framed) over a :class:`PolicyServer`.

    Run it with ``await fe.start()`` inside an event loop, or from
    synchronous code through :func:`start_frontend` (a dedicated loop
    thread). ``example_obs`` / ``example_mask`` fix the wire schema: one
    request's body is exactly ``obs.nbytes + mask.nbytes`` raw bytes in
    that order, C-contiguous, same dtypes.
    """

    def __init__(self, server: PolicyServer, example_obs: Any,
                 example_mask: Any, host: str = "127.0.0.1",
                 port: int = 0, registry=None,
                 high_water: int = 256, low_water: int = 64):
        if not 0 <= low_water < high_water:
            raise ValueError(f"need 0 <= low_water < high_water, got "
                             f"{low_water} / {high_water}")
        for what, x in (("obs", example_obs), ("mask", example_mask)):
            if isinstance(x, (dict, tuple, list)):
                raise TypeError(
                    f"the front door serves one-array rows; example_{what} "
                    f"is a {type(x).__name__} (a tree-shaped request, such "
                    f"as the hierarchical config's dict observation, is "
                    f"served in process by PolicyServer.submit only)")
        self.server = server
        self.host = host
        self.port = int(port)            # 0 = ephemeral; set by start()
        self.high_water = int(high_water)
        self.low_water = int(low_water)
        obs0 = np.ascontiguousarray(example_obs)
        mask0 = np.ascontiguousarray(example_mask)
        self._obs_shape, self._obs_dtype = obs0.shape, obs0.dtype
        self._mask_shape, self._mask_dtype = mask0.shape, mask0.dtype
        self._obs_nbytes, self._mask_nbytes = obs0.nbytes, mask0.nbytes
        self._obs_count = int(np.prod(self._obs_shape, dtype=np.int64))
        self._mask_count = int(np.prod(self._mask_shape, dtype=np.int64))
        # frame mode validates the request schema by byte equality
        # against this descriptor: one ==, no parse on the hot path
        self._req_descriptor = (wire.descriptor(obs0) + b"|"
                                + wire.descriptor(mask0))
        # size the arena from the wire schema, so the first request
        # never pays slab construction mid-traffic
        ensure = getattr(server, "ensure_arena", None)
        if callable(ensure):
            ensure(obs0, mask0)
        self._draining = False
        self._drained: "asyncio.Future | None" = None
        # every open connection's writer (the linger and the loop's
        # shutdown close what is left), and strong refs to the tasks
        # serving accept-queue stragglers
        self._conns: "set[asyncio.StreamWriter]" = set()
        self._backlog_refusals: "set[asyncio.Task]" = set()
        self._inflight = 0
        self._tcp: "asyncio.base_events.Server | None" = None
        self._gate: "asyncio.Event | None" = None       # set = reads flow
        self._idle: "asyncio.Event | None" = None       # set = no inflight
        self._bp_task: "asyncio.Task | None" = None
        reg = registry if registry is not None else server.registry
        self._http_requests = reg.counter(
            "serve_frontend_requests_total",
            "HTTP decide requests read off the wire")
        self._http_shed = reg.counter(
            "serve_frontend_shed_total",
            "HTTP decide requests answered 503 with Retry-After "
            "(deadline shed)")
        self._http_closed = reg.counter(
            "serve_frontend_closed_total",
            "HTTP decide requests refused because the server is "
            "draining/closed")
        self._http_bad = reg.counter(
            "serve_frontend_bad_requests_total",
            "HTTP requests answered 400 (malformed wire input)")
        self._pauses = reg.counter(
            "serve_frontend_backpressure_pauses_total",
            "times the listener stopped reading sockets at the "
            "queue-depth high-water mark")
        self._g_paused = reg.gauge(
            "serve_frontend_paused",
            "1 while socket reads are paused for backpressure")

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def draining(self) -> bool:
        return self._draining

    # ---- lifecycle ---------------------------------------------------

    async def start(self) -> int:
        """Bind and serve (returns at once; the listener runs on the
        current event loop). Returns the bound port."""
        if self._tcp is not None:
            raise RuntimeError("frontend already started")
        self._gate = asyncio.Event()
        self._gate.set()
        self._idle = asyncio.Event()
        self._idle.set()
        self._tcp = await asyncio.start_server(
            self._on_connection, self.host, self.port)
        self.port = self._tcp.sockets[0].getsockname()[1]
        self._bp_task = asyncio.get_running_loop().create_task(
            self._backpressure_loop())
        return self.port

    async def drain(self) -> None:
        """Graceful shutdown: stop accepting, flush in-flight requests,
        then permanently close the policy server so any straggler submit
        raises :class:`ServerClosedError`. Idempotent: a second call
        waits for the first drain and shares its outcome. Raises
        ``TimeoutError`` if requests are still in flight after
        ``DRAIN_GRACE_S`` (the server is closed all the same)."""
        if self._drained is None:
            self._drained = asyncio.ensure_future(self._drain())
        await asyncio.shield(self._drained)

    async def _drain(self) -> None:
        self._draining = True
        loop = asyncio.get_running_loop()
        if self._tcp is not None and self._tcp.sockets:
            # A connection that finished its TCP handshake but is not yet
            # a transport when the listener closes would be orphaned:
            # (a) accepted by the selector with its accept task queued
            # (Server._attach asserts once the server is closed), or
            # (b) still in the kernel accept queue (Linux does not reset
            # queued connections when the listener closes). Stop the
            # accept reader first, tick the loop so queued accept tasks
            # attach while the server is open, dup the listening sockets
            # (the accept queue lives on the shared file description),
            # close the listener and hand every queued connection to the
            # normal handler, which now answers with the typed refusal.
            for ts in self._tcp.sockets:
                try:
                    loop.remove_reader(ts.fileno())
                except (ValueError, OSError):
                    pass
            await asyncio.sleep(0)
            await asyncio.sleep(0)
            backlog = [ts.dup() for ts in self._tcp.sockets]
            self._tcp.close()
            # no Server.wait_closed() here: on 3.12 it waits for every
            # open connection too (the module docstring)
            await self._refuse_backlog(backlog)
        if self._gate is not None:
            # wake paused readers: their next request gets a typed refusal
            self._gate.set()
        try:
            if self._idle is not None:
                await asyncio.wait_for(self._idle.wait(), DRAIN_GRACE_S)
        finally:
            if self._bp_task is not None:
                self._bp_task.cancel()
            # PolicyServer.close joins dispatcher threads: off the loop
            await asyncio.to_thread(self.server.close)
            loop.call_later(DRAIN_LINGER_S, self.close_connections)

    def close_connections(self) -> None:
        """Close every open connection (its client reads an EOF). Runs
        ``DRAIN_LINGER_S`` after a drain, and at the loop's shutdown."""
        for w in list(self._conns):
            w.close()

    async def _refuse_backlog(self, socks: "list[socket.socket]") -> None:
        """Accept whatever the kernel queued on the (now closed) listener
        and serve each straggler through the normal handler as a loop
        task (``_draining`` is set, so it gets the typed refusal with
        ``Connection: close``). The tasks are not awaited: a straggler
        that connected but never sends must not hold the drain in the
        protocol sniff; the linger closes it."""
        for ls in socks:
            ls.setblocking(False)
            while True:
                try:
                    conn, _ = ls.accept()
                except (BlockingIOError, InterruptedError, OSError):
                    break
                reader, writer = await asyncio.open_connection(sock=conn)
                task = asyncio.ensure_future(
                    self._on_connection(reader, writer))
                self._backlog_refusals.add(task)
                task.add_done_callback(self._backlog_refusals.discard)
            ls.close()

    # ---- backpressure ------------------------------------------------

    async def _backpressure_loop(self) -> None:
        """Sample the queue depth; gate socket reads between the high-
        and low-water marks (hysteresis, so the gate cannot flap on a
        depth hovering at one threshold)."""
        assert self._gate is not None
        while not self._draining:
            depth = self.server.queue_depth()
            if self._gate.is_set():
                if depth >= self.high_water:
                    self._gate.clear()
                    self._pauses.inc()
                    self._g_paused.set(1)
            elif depth <= self.low_water:
                self._gate.set()
                self._g_paused.set(0)
            await asyncio.sleep(POLL_S)

    # ---- connection handling -----------------------------------------

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        assert self._gate is not None and self._idle is not None
        self._conns.add(writer)
        try:
            # protocol sniff: a framed connection announces itself with
            # the 4 magic bytes; anything else is HTTP (the sniffed bytes
            # are threaded back into the request-line parse)
            sniff = b""
            while len(sniff) < len(wire.MAGIC):
                chunk = await reader.read(len(wire.MAGIC) - len(sniff))
                if not chunk:
                    break
                sniff += chunk
            if not sniff:
                return
            if sniff == wire.MAGIC:
                await self._serve_framed(reader, writer, sniff)
            else:
                await self._serve_http(reader, writer, sniff)
        except (asyncio.IncompleteReadError, ConnectionError):
            return   # the client went away mid-request: nothing to answer
        finally:
            self._conns.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    async def _serve_http(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter,
                          prefix: bytes) -> None:
        """HTTP/1.1 keep-alive loop: one connection serves N requests
        until the client asks ``Connection: close``, EOF, or the server
        refuses further work (drain); refusals carry ``Connection:
        close`` so a well-behaved client re-resolves instead of
        pipelining into a dying socket."""
        while True:
            # connection-level backpressure: do not even READ the next
            # request while the queue is past high-water
            if not self._gate.is_set():
                await self._gate.wait()
            try:
                req = await self._read_request(reader, prefix)
            except _BadRequest as e:
                # the request FRAMING is broken: answer 400 and close,
                # since the stream cannot be resynchronized
                self._http_bad.inc()
                writer.write(_response("400 Bad Request",
                                       {"error": "bad-request",
                                        "detail": str(e)}, close=True))
                await writer.drain()
                return
            prefix = b""
            if req is None:
                return
            try:
                resp, close = await self._handle(*req)
            except _BadRequest as e:
                self._http_bad.inc()
                resp, close = _response("400 Bad Request",
                                        {"error": "bad-request",
                                         "detail": str(e)}), False
            headers = req[2]
            if headers.get("connection", "").lower() == "close":
                if not close:
                    resp = resp.replace(b"Connection: keep-alive",
                                        b"Connection: close", 1)
                close = True
            writer.write(resp)
            await writer.drain()
            if close:
                return

    async def _read_request(self, reader: asyncio.StreamReader,
                            prefix: bytes = b""):
        try:
            line = await reader.readline()
            if not line and not prefix:
                return None       # clean EOF between requests
            line = prefix + line
            parts = line.decode("latin-1").split()
            if len(parts) != 3:
                raise _BadRequest("malformed request line")
            method, path = parts[0], parts[1]
            headers: dict[str, str] = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                key, _, val = h.decode("latin-1").partition(":")
                headers[key.strip().lower()] = val.strip()
        except ValueError as e:      # a line over the stream's limit
            raise _BadRequest("request line or header too long") from e
        try:
            length = int(headers.get("content-length", "0") or "0")
        except ValueError as e:
            raise _BadRequest("bad Content-Length") from e
        body = await reader.readexactly(length) if length > 0 else b""
        return method, path, headers, body

    def _parse_body(self, body: bytes) -> "tuple[np.ndarray, np.ndarray]":
        """(obs, mask) as read-only **views** over ``body``, never
        copies: the one copy is ``submit``'s arena slot write, which
        happens before the views' frame returns."""
        expected = self._obs_nbytes + self._mask_nbytes
        if len(body) != expected:
            raise _BadRequest(
                f"body must be exactly {expected} bytes "
                f"(obs {self._obs_shape} {self._obs_dtype} + mask "
                f"{self._mask_shape} {self._mask_dtype}), got {len(body)}")
        obs = np.frombuffer(body, dtype=self._obs_dtype,
                            count=self._obs_count).reshape(self._obs_shape)
        mask = np.frombuffer(body, dtype=self._mask_dtype,
                             offset=self._obs_nbytes,
                             count=self._mask_count).reshape(
                                 self._mask_shape)
        return obs, mask

    def _retry_after_s(self, exc: DeadlineSheddedError) -> float:
        """Backoff hint: one learned service time (the dispatch that has
        to finish before the queue moves), plus the predicted excess
        wait of an admission shed; 1 s while the estimator is cold (a
        ``set_active`` re-warm resets it, so a stale pre-swap value never
        prices this hint). Clamped to [``RETRY_AFTER_MIN_S``,
        ``RETRY_AFTER_MAX_S``]."""
        svc = self.server.service_time_s()
        retry = svc if svc is not None else 1.0
        if exc.predicted_wait_s is not None:
            retry += max(exc.predicted_wait_s - exc.deadline_s, 0.0)
        return min(max(retry, RETRY_AFTER_MIN_S), RETRY_AFTER_MAX_S)

    async def _decide(self, obs, mask, stall: int,
                      deadline_s: "float | None", req_id: int):
        """The transport-agnostic decide core: submit, await, classify.
        Returns ``(status, payload)``: ``"ok"`` (a
        :class:`~.batching.ServeResult`), ``"shed"`` ((exc,
        retry_after_s)), ``"closed"`` (a detail string) or
        ``"timeout"``. A failed dispatch is not classified: its
        exception propagates and the connection closes unanswered."""
        assert self._idle is not None
        self._inflight += 1
        self._idle.clear()
        try:
            try:
                fut = self.server.submit(obs, mask, stall=stall,
                                         deadline_s=deadline_s,
                                         req_id=req_id)
            except ServerClosedError:
                return "closed", "server is draining"
            try:
                result = await asyncio.wait_for(
                    asyncio.wrap_future(fut), REQUEST_TIMEOUT_S)
            except DeadlineSheddedError as e:
                return "shed", (e, self._retry_after_s(e))
            except ServerClosedError:
                return "closed", "server closed mid-request"
            except asyncio.TimeoutError:
                return "timeout", None
            return "ok", result
        finally:
            self._inflight -= 1
            if self._inflight == 0:
                self._idle.set()

    @staticmethod
    def _request_id(headers: dict) -> int:
        if "x-request-id" not in headers:
            return 0
        try:
            req_id = int(headers["x-request-id"], 0)
        except ValueError as e:
            raise _BadRequest("bad X-Request-Id") from e
        if not 0 <= req_id < (1 << 63):
            raise _BadRequest("X-Request-Id must be in [0, 2**63)")
        return req_id

    async def _handle(self, method: str, path: str, headers: dict,
                      body: bytes) -> "tuple[bytes, bool]":
        """One HTTP request -> (response bytes, close-connection flag).
        Drain refusals close: a kept-alive client pipelining into a
        draining server gets the typed 503 AND the signal to
        re-resolve."""
        if method == "GET" and path == HEALTH_PATH:
            return _response("200 OK", {
                "status": "draining" if self._draining else "ok",
                "queue_depth": self.server.queue_depth()}), False
        if method != "POST" or path != DECIDE_PATH:
            return _response("404 Not Found", {"error": "unknown route",
                                               "path": path}), False
        self._http_requests.inc()
        if self._draining:
            self._http_closed.inc()
            return _response("503 Service Unavailable",
                             {"error": "closed",
                              "detail": "server is draining"},
                             close=True), True
        obs, mask = self._parse_body(body)
        deadline_s = None
        if "x-deadline-ms" in headers:
            try:
                deadline_s = float(headers["x-deadline-ms"]) / 1e3
            except ValueError as e:
                raise _BadRequest("bad X-Deadline-Ms") from e
            if not (math.isfinite(deadline_s) and deadline_s > 0):
                raise _BadRequest("X-Deadline-Ms must be finite and > 0")
        try:
            stall = int(headers.get("x-stall", "0") or "0")
        except ValueError as e:
            raise _BadRequest("bad X-Stall") from e
        req_id = self._request_id(headers) or self.server.mint_request_id()

        status, payload = await self._decide(obs, mask, stall, deadline_s,
                                             req_id)
        if status == "closed":
            self._http_closed.inc()
            return _response("503 Service Unavailable",
                             {"error": "closed", "detail": payload,
                              "request_id": req_id},
                             close=True), True
        if status == "shed":
            exc, retry = payload
            self._http_shed.inc()
            return _response(
                "503 Service Unavailable",
                {"error": "shed", "reason": exc.reason,
                 "deadline_ms": exc.deadline_s * 1e3,
                 "waited_ms": exc.waited_s * 1e3,
                 "retry_after_s": retry,
                 "request_id": req_id},
                (f"Retry-After: {retry:.3f}",)), False
        if status == "timeout":
            return _response("504 Gateway Timeout",
                             {"error": "timeout",
                              "timeout_s": REQUEST_TIMEOUT_S,
                              "request_id": req_id}), False
        return _response("200 OK",
                         {"action": np.asarray(payload.action).tolist(),
                          "latency_ms": payload.latency_s * 1e3,
                          "request_id": req_id}), False

    # ---- frame mode --------------------------------------------------

    async def _read_frame(self, reader: asyncio.StreamReader,
                          preread: bytes = b""):
        # sniff the version byte: v1 prefixes are 24 bytes, v2 are 32
        # (8 more bytes of req_id), as in wire.recv_frame
        head = preread + await reader.readexactly(
            wire.PREFIX_V1_SIZE - len(preread))
        if head[4] == wire.VERSION:
            head += await reader.readexactly(
                wire.PREFIX_SIZE - wire.PREFIX_V1_SIZE)
        kind, hlen, blen, meta64, meta32, req_id = wire.unpack_prefix(head)
        header = await reader.readexactly(hlen) if hlen else b""
        body = await reader.readexactly(blen) if blen else b""
        return kind, header, body, meta64, meta32, req_id

    async def _serve_framed(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter,
                            sniffed: bytes) -> None:
        """The binary dialect: one persistent connection, N request
        frames, the same shedding and drain semantics as HTTP; an ERR
        frame with reason ``closed`` ends the connection, as
        ``Connection: close`` on a 503 does."""
        preread = sniffed
        while True:
            if not self._gate.is_set():
                await self._gate.wait()
            try:
                frame = await self._read_frame(reader, preread)
            except wire.WireError as e:
                self._http_bad.inc()
                writer.write(wire.pack_error("bad-request",
                                             {"detail": str(e)}))
                await writer.drain()
                return      # framing is lost; the stream cannot resync
            preread = b""
            resp, close = await self._handle_frame(*frame)
            writer.write(resp)
            await writer.drain()
            if close:
                return

    async def _handle_frame(self, kind: int, header: bytes, body: bytes,
                            meta64: int, meta32: int, req_id: int = 0):
        if kind != wire.KIND_REQ:
            self._http_bad.inc()
            return wire.pack_error(
                "bad-request",
                {"detail": f"expected KIND_REQ, got {kind}"},
                req_id=req_id), True
        if req_id >= (1 << 63):
            # the wire field is uint64 but the causality lane is int64:
            # refuse rather than truncate
            self._http_bad.inc()
            return wire.pack_error(
                "bad-request",
                {"detail": "req_id must be < 2**63"}), False
        self._http_requests.inc()
        if not req_id:
            req_id = self.server.mint_request_id()
        if self._draining:
            self._http_closed.inc()
            return wire.pack_error(
                "closed", {"detail": "server is draining"},
                req_id=req_id), True
        if header != self._req_descriptor:
            self._http_bad.inc()
            return wire.pack_error(
                "bad-request",
                {"detail": f"descriptor mismatch: got {header!r}, "
                           f"serving {self._req_descriptor.decode()}"},
                req_id=req_id), False
        expected = self._obs_nbytes + self._mask_nbytes
        if len(body) != expected:
            self._http_bad.inc()
            return wire.pack_error(
                "bad-request",
                {"detail": f"body must be exactly {expected} bytes, "
                           f"got {len(body)}"},
                req_id=req_id), False
        obs, mask = self._parse_body(body)
        deadline_s = meta64 / 1e6 if meta64 else None
        status, payload = await self._decide(obs, mask, int(meta32),
                                             deadline_s, req_id)
        if status == "closed":
            self._http_closed.inc()
            return wire.pack_error("closed", {"detail": payload},
                                   req_id=req_id), True
        if status == "shed":
            exc, retry = payload
            self._http_shed.inc()
            return wire.pack_error(
                f"shed:{exc.reason}",
                {"deadline_ms": exc.deadline_s * 1e3,
                 "waited_ms": exc.waited_s * 1e3,
                 "retry_after_s": retry},
                retry_after_s=retry, req_id=req_id), False
        if status == "timeout":
            return wire.pack_error(
                "timeout", {"timeout_s": REQUEST_TIMEOUT_S},
                req_id=req_id), False
        return wire.pack_response(np.asarray(payload.action),
                                  payload.latency_s, req_id=req_id), False


class FrontendHandle:
    """Synchronous handle over a :class:`ServeFrontend` running on its
    own event-loop thread (:func:`start_frontend`). Every wait is
    bounded: a handle never hangs its caller."""

    def __init__(self, frontend: ServeFrontend,
                 loop: asyncio.AbstractEventLoop,
                 thread: threading.Thread):
        self.frontend = frontend
        self._loop = loop
        self._thread = thread
        self._prev_sigterm = None

    @property
    def port(self) -> int:
        return self.frontend.port

    @property
    def url(self) -> str:
        return self.frontend.url

    def drain(self, timeout: float = 60.0) -> None:
        """Run the graceful drain to completion (blocking, bounded).
        After :meth:`close` (which drained) it returns at once."""
        if self._loop.is_closed():
            return
        asyncio.run_coroutine_threadsafe(
            self.frontend.drain(), self._loop).result(timeout=timeout)

    def install_sigterm(self) -> None:
        """SIGTERM -> graceful drain, scheduled on the loop thread (the
        handler itself never blocks). Main thread only, as
        ``signal.signal`` is."""
        def _on_sigterm(signum, frame):
            asyncio.run_coroutine_threadsafe(
                self.frontend.drain(), self._loop)
        self._prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)

    def close(self) -> None:
        """Drain (if not already), then stop and join the loop thread,
        which closes every connection still open. Idempotent."""
        if self._loop.is_closed():
            return
        try:
            self.drain()
        finally:
            if self._prev_sigterm is not None:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
                self._prev_sigterm = None
            if not self._loop.is_closed():
                self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=10)


def start_frontend(server: PolicyServer, example_obs: Any,
                   example_mask: Any, **kw: Any) -> FrontendHandle:
    """Start a :class:`ServeFrontend` on a dedicated event-loop thread
    and block (bounded) until it is bound. Keyword arguments pass
    through to the :class:`ServeFrontend` constructor."""
    fe = ServeFrontend(server, example_obs, example_mask, **kw)
    loop = asyncio.new_event_loop()
    bound: Future = Future()

    def _frontend_loop():
        asyncio.set_event_loop(loop)
        try:
            port = loop.run_until_complete(fe.start())
        except BaseException as e:   # a bind failure must not hang callers
            bound.set_exception(e)
            loop.close()
            return
        bound.set_result(port)
        try:
            loop.run_forever()
        finally:
            # close what is still open (clients read an EOF), let the
            # cancelled handlers run their finally blocks, bounded
            fe.close_connections()
            tasks = asyncio.all_tasks(loop)
            for task in tasks:
                task.cancel()
            if tasks:
                loop.run_until_complete(asyncio.wait(tasks, timeout=5.0))
            loop.run_until_complete(loop.shutdown_asyncgens())
            loop.close()

    t = threading.Thread(target=_frontend_loop, name="serve-frontend",
                         daemon=True)
    t.start()
    bound.result(timeout=30)
    return FrontendHandle(fe, loop, t)
