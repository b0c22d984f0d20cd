"""Length-prefixed binary framing for the serving front door.

The port's copy of the JAX package's ``serve/wire.py`` (numpy and the
standard library): the same bytes on the wire, so a client of either
package talks to a front door of either. HTTP/1.1 costs a request-line
and header parse per decide; for high-fan-in clients that cost dominates
the host path once the data plane itself is zero-copy. This module
defines the **frame mode** the frontend speaks on the same port: a
connection whose first 4 bytes are ``MAGIC`` is framed for its whole
life, anything else is HTTP. One v2 frame is::

    <4s B  B    H        I         Q        I       Q   >  little-endian
    magic ver kind  header_len  body_len  meta64  meta32  req_id
    [header: header_len bytes][body: body_len bytes]

- ``kind=KIND_REQ``: the header is the request **descriptor**, an exact
  ascii encoding of the wire schema (``float32:(6,)|bool:(9,)``) that
  the server validates by BYTE EQUALITY against its own (one ``==``, no
  parsing on the hot path); ``meta64`` is the deadline in microseconds
  (0 = no SLO), ``meta32`` the stall count; the body is the raw
  C-contiguous obs bytes followed by the mask bytes. ``np.frombuffer``
  views them straight into :meth:`.batching.PolicyServer.submit`, whose
  arena slot write is the single copy of the request's life.
- ``kind=KIND_RESP``: the header is the action descriptor, ``meta64``
  the decision latency in microseconds, the body the raw action bytes.
- ``kind=KIND_ERR``: the header is a short ascii reason
  (``shed:admission``, ``shed:expired``, ``closed``, ``bad-request``),
  ``meta64`` the suggested retry-after in microseconds (0 = do not
  retry here), the body a small JSON detail payload mirroring the HTTP
  error shape.

``req_id`` (v2) is the request-causality key: a 64-bit id the client
may supply (0 = let the server mint one) that the server threads through
the arena and every response or error frame of that request, the join
key ``python -m rlgpuschedule_tpu_torch.obs.report --request`` rebuilds a
timeline from.

**Versions**: ``VERSION`` is 2 and :func:`pack_frame` always emits the
32-byte v2 prefix, but v1 frames (24-byte prefix, no ``req_id``) still
decode: :func:`unpack_prefix` accepts both sizes and :func:`recv_frame`
sniffs the version byte before it reads the prefix's tail. A v1 frame
carries ``req_id == 0`` ("unassigned").

Trees (a dict observation) are flattened by :func:`..tree.leaves`, in
``jax.tree``'s sorted-key order; a ``None`` is an empty subtree, as in
``jax.tree``, so the descriptor bytes equal the JAX package's for every
tree.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Any

import numpy as np

from ..tree import leaves

MAGIC = b"RLSF"
VERSION = 2
KIND_REQ = 1
KIND_RESP = 2
KIND_ERR = 3
_KINDS = (KIND_REQ, KIND_RESP, KIND_ERR)

PREFIX = struct.Struct("<4sBBHIQIQ")
PREFIX_SIZE = PREFIX.size            # 32 bytes (v2)
PREFIX_V1 = struct.Struct("<4sBBHIQI")
PREFIX_V1_SIZE = PREFIX_V1.size      # 24 bytes (v1, no req_id)

# defensive ceiling: a frame is one request/response row, never a
# training batch; anything bigger is a corrupt or hostile prefix
MAX_BODY_BYTES = 64 * 1024 * 1024


class WireError(ValueError):
    """Malformed frame (bad magic/version/kind, oversized, or a
    descriptor mismatch). Maps to the transport's bad-request path."""


def _leaves(tree: Any) -> "list[np.ndarray]":
    """The host leaves of ``tree`` in ``jax.tree.leaves`` order (a
    ``None`` is an empty subtree there, not a leaf)."""
    return [np.asarray(x) for x in leaves(tree) if x is not None]


def descriptor(tree: Any) -> bytes:
    """Exact ascii schema of a host tree's leaves, in leaf order:
    ``dtype:(shape)`` joined by ``|``. Validation is byte equality: two
    ends agree iff their descriptors are identical."""
    return "|".join(f"{x.dtype.name}:{x.shape}"
                    for x in _leaves(tree)).encode("ascii")


def pack_frame(kind: int, header: bytes, body: bytes = b"",
               meta64: int = 0, meta32: int = 0, req_id: int = 0) -> bytes:
    if kind not in _KINDS:
        raise WireError(f"unknown frame kind {kind}")
    if len(header) > 0xFFFF:
        raise WireError(f"header too large ({len(header)} bytes)")
    if len(body) > MAX_BODY_BYTES:
        raise WireError(f"body too large ({len(body)} bytes)")
    return PREFIX.pack(MAGIC, VERSION, kind, len(header), len(body),
                       meta64, meta32, req_id) + header + body


def unpack_prefix(buf: bytes) -> "tuple[int, int, int, int, int, int]":
    """Parse one frame prefix -> (kind, header_len, body_len, meta64,
    meta32, req_id). Accepts the 32-byte v2 prefix AND the legacy
    24-byte v1 prefix (``req_id`` reads as 0); raises :class:`WireError`
    on anything that is not a well-formed, sane frame head."""
    if len(buf) == PREFIX_SIZE:
        magic, version, kind, hlen, blen, meta64, meta32, req_id = \
            PREFIX.unpack(buf)
        if version != VERSION:
            raise WireError(f"unsupported wire version {version} for a "
                            f"{PREFIX_SIZE}-byte prefix")
    elif len(buf) == PREFIX_V1_SIZE:
        magic, version, kind, hlen, blen, meta64, meta32 = \
            PREFIX_V1.unpack(buf)
        req_id = 0
        if version != 1:
            raise WireError(f"unsupported wire version {version} for a "
                            f"{PREFIX_V1_SIZE}-byte prefix")
    else:
        raise WireError(f"prefix must be {PREFIX_V1_SIZE} (v1) or "
                        f"{PREFIX_SIZE} (v2) bytes, got {len(buf)}")
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if kind not in _KINDS:
        raise WireError(f"unknown frame kind {kind}")
    if blen > MAX_BODY_BYTES:
        raise WireError(f"body length {blen} exceeds {MAX_BODY_BYTES}")
    return kind, hlen, blen, meta64, meta32, req_id


def pack_request(obs: Any, mask: Any, deadline_s: "float | None" = None,
                 stall: int = 0, req_id: int = 0) -> bytes:
    """Client-side helper: one decide request as a single frame."""
    body = b"".join(np.ascontiguousarray(x).tobytes()
                    for x in _leaves(obs) + _leaves(mask))
    header = descriptor(obs) + b"|" + descriptor(mask)
    meta64 = 0 if deadline_s is None else max(int(deadline_s * 1e6), 1)
    return pack_frame(KIND_REQ, header, body, meta64=meta64,
                      meta32=int(stall), req_id=req_id)


def pack_response(action: Any, latency_s: float, req_id: int = 0) -> bytes:
    arr = np.ascontiguousarray(action)
    return pack_frame(KIND_RESP, descriptor(arr), arr.tobytes(),
                      meta64=max(int(latency_s * 1e6), 0), req_id=req_id)


def pack_error(reason: str, detail: dict,
               retry_after_s: "float | None" = None,
               req_id: int = 0) -> bytes:
    meta64 = (0 if retry_after_s is None
              else max(int(retry_after_s * 1e6), 1))
    return pack_frame(KIND_ERR, reason.encode("ascii"),
                      json.dumps(detail).encode(), meta64=meta64,
                      req_id=req_id)


def recv_frame(
        sock: socket.socket
) -> "tuple[int, bytes, bytes, int, int, int]":
    """Blocking client-side frame read -> (kind, header, body, meta64,
    meta32, req_id). Version-sniffing: reads the 24-byte v1 head, then
    the 8-byte v2 tail iff the version byte says so. Raises
    :class:`ConnectionError` on EOF mid-frame, and ``EOFError`` on a
    clean EOF at a frame boundary."""
    def read_exact(n: int, at_boundary: bool = False) -> bytes:
        chunks = []
        got = 0
        while got < n:
            c = sock.recv(n - got)
            if not c:
                if at_boundary and got == 0:
                    raise EOFError("connection closed at frame boundary")
                raise ConnectionError("connection closed mid-frame")
            chunks.append(c)
            got += len(c)
        return b"".join(chunks)

    head = read_exact(PREFIX_V1_SIZE, at_boundary=True)
    if head[4] == VERSION:
        head += read_exact(PREFIX_SIZE - PREFIX_V1_SIZE)
    kind, hlen, blen, meta64, meta32, req_id = unpack_prefix(head)
    header = read_exact(hlen) if hlen else b""
    body = read_exact(blen) if blen else b""
    return kind, header, body, meta64, meta32, req_id


def unpack_action(header: bytes, body: bytes) -> np.ndarray:
    """Decode a KIND_RESP payload back into the action array (client
    side). The descriptor grammar is ``dtype:(shape)``. Returns a
    read-only **view** over ``body`` (``bytes`` is immutable and the
    view keeps it alive, so no copy is needed)."""
    try:
        dtype_name, _, shape_s = header.decode("ascii").partition(":")
        shape = tuple(int(d) for d in
                      shape_s.strip("()").split(",") if d.strip())
        return np.frombuffer(body, dtype=np.dtype(dtype_name)).reshape(
            shape)
    except (ValueError, TypeError) as e:
        raise WireError(f"bad action descriptor {header!r}") from e
