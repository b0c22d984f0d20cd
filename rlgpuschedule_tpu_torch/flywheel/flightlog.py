"""Crash-safe served-traffic flight log: the flywheel's write path.

Counterpart of the JAX package's ``flywheel/flightlog.py``, with its
on-disk format: a log written by either package reads back in the
other. Numpy and files only: nothing here touches torch, so the writer
may run on a dispatcher thread under the sync guard
(:func:`..analysis.sentinels.no_implicit_transfers`).

:class:`FlightLogWriter` owns one recycled shard buffer, allocated from
the first batch's shapes and reused for every shard. A full buffer is
**sealed**: written to a temp file, renamed to ``shard-NNNNNN.npz``, and
only then described by a crc32 sidecar ``.crc/shard-NNNNNN.json`` (the
checkpoint's sidecar pattern, :mod:`..checkpoint`). Payload before
sidecar is the torn-tail contract: a crash leaves at most one trailing
shard without a valid sidecar, which :func:`read_flight_log` drops and
flags; a bad shard anywhere earlier is corruption and raises.

Columns of a shard (the leaves of a tree column are enumerated in
``jax.tree``'s sorted-key order by :func:`..tree.leaves`; a ``None`` is
an empty subtree, as on the wire):

==============  =======================================================
``obs<i>``      observation leaves, one row per served request
``mask<i>``     action-mask leaves
``act<i>``      the served greedy action leaves
``log_prob``    joint behavior log-prob of the served action (f32), from
                the engine's capture graph
                (:func:`..decision.policy_decision_full`)
``value``       the behavior critic's estimate (f32)
``stall``       the client's consecutive zero-dt count (i32)
``outcome``     deadline outcome (i8): 0 no deadline, 1 met, 2 late
``req_id``      the server's request id (i64; 0 = unassigned)
``policy_step`` scalar i64: the behavior policy's train step
==============  =======================================================

Conservation: shed requests never reach a dispatch, so ``rows_logged``
equals the server's ``served`` count exactly.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
from typing import Any

import numpy as np

from ..checkpoint import _crc32_file
from ..tree import leaves

_SHARD_RE = re.compile(r"^shard-(\d{6})\.npz$")


def shard_name(seq: int) -> str:
    return f"shard-{seq:06d}.npz"


def _sidecar_path(directory: str, seq: int) -> str:
    return os.path.join(directory, ".crc", f"shard-{seq:06d}.json")


class FlightLogError(RuntimeError):
    """Base: the flight log on disk cannot be used as asked."""


class FlightLogCorruptError(FlightLogError):
    """A non-tail shard failed its crc or sidecar check: interior
    corruption, not a torn tail."""


def _leaves(tree: Any) -> "list[np.ndarray]":
    """The tree's array leaves in ``jax.tree`` order (``None`` is an
    empty subtree)."""
    return [np.asarray(x) for x in leaves(tree) if x is not None]


class FlightLogWriter:
    """Appends served rows into one recycled buffer and seals full (or
    the final partial) buffers to crc-sidecar'd shards.

    Thread-safe: dispatcher pumps append concurrently under one lock.
    ``durable=True`` fsyncs each sealed payload and sidecar before the
    rename publishes it (power-loss durability); the default rides the
    page cache, where a process crash still loses nothing sealed."""

    def __init__(self, directory: str, capacity: int = 4096,
                 policy_step: int = 0, registry=None, bus=None,
                 durable: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.directory = os.path.abspath(directory)
        os.makedirs(os.path.join(self.directory, ".crc"), exist_ok=True)
        self.capacity = int(capacity)
        self.policy_step = int(policy_step)
        self.durable = bool(durable)
        self._bus = bus
        self._lock = threading.Lock()
        self._obs: "list[np.ndarray] | None" = None
        self._mask: "list[np.ndarray] | None" = None
        self._act: "list[np.ndarray] | None" = None
        self._lp = np.zeros(capacity, np.float32)
        self._value = np.zeros(capacity, np.float32)
        self._stall = np.zeros(capacity, np.int32)
        self._outcome = np.zeros(capacity, np.int8)
        self._req = np.zeros(capacity, np.int64)
        self._n = 0
        self._seq = 0
        self._seq_rows = 0       # rows already sealed to disk
        self._closed = False
        if registry is not None:
            self._c_rows = registry.counter(
                "flywheel_rows_logged_total",
                "served decision rows appended to the flight log "
                "(conservation: must equal the server's served count)")
            self._c_shards = registry.counter(
                "flywheel_shards_sealed_total",
                "flight-log shards sealed to disk with crc sidecars")
        else:
            self._c_rows = self._c_shards = None

    @property
    def rows_logged(self) -> int:
        """Rows accepted: sealed plus still buffered."""
        with self._lock:
            return self._seq_rows + self._n

    @property
    def shards_sealed(self) -> int:
        with self._lock:
            return self._seq

    def _alloc(self, obs_l, mask_l, act_l) -> None:
        cap = self.capacity
        mk = lambda ls: [np.zeros((cap,) + l.shape[1:], l.dtype)
                         for l in ls]
        self._obs, self._mask, self._act = mk(obs_l), mk(mask_l), mk(act_l)

    def append_batch(self, obs: Any, mask: Any, actions: Any,
                     log_prob, value, stall, outcome,
                     req_id=None) -> None:
        """Append one dispatch's rows (leading axis = rows; trees for
        ``obs``/``mask``/``actions``): copied into the recycled buffer,
        sealing as many full shards as the batch fills. ``req_id`` is
        one id per row (``None`` writes zeros, "unassigned")."""
        obs_l, mask_l, act_l = _leaves(obs), _leaves(mask), _leaves(actions)
        lp = np.asarray(log_prob, np.float32)
        val = np.asarray(value, np.float32)
        st = np.asarray(stall, np.int32)
        oc = np.asarray(outcome, np.int8)
        n = int(lp.shape[0])
        rid = (np.zeros(n, np.int64) if req_id is None
               else np.asarray(req_id, np.int64))
        if rid.shape != (n,):
            raise ValueError(
                f"req_id must be one id per row: got shape {rid.shape} "
                f"for {n} rows")
        with self._lock:
            if self._closed:
                raise FlightLogError("FlightLogWriter is closed")
            if self._obs is None:
                self._alloc(obs_l, mask_l, act_l)
            off = 0
            while off < n:
                m = min(self.capacity - self._n, n - off)
                s, e = self._n, self._n + m
                for dst, src in zip(self._obs + self._mask + self._act,
                                    obs_l + mask_l + act_l):
                    dst[s:e] = src[off:off + m]
                self._lp[s:e] = lp[off:off + m]
                self._value[s:e] = val[off:off + m]
                self._stall[s:e] = st[off:off + m]
                self._outcome[s:e] = oc[off:off + m]
                self._req[s:e] = rid[off:off + m]
                self._n += m
                off += m
                if self._n == self.capacity:
                    self._seal_locked()
            if self._c_rows is not None:
                self._c_rows.inc(n)

    def _seal_locked(self) -> None:
        n, seq = self._n, self._seq
        if n == 0:
            return
        cols: "dict[str, np.ndarray]" = {}
        for pre, ls in (("obs", self._obs), ("mask", self._mask),
                        ("act", self._act)):
            for i, l in enumerate(ls):
                cols[f"{pre}{i}"] = l[:n]
        cols["log_prob"] = self._lp[:n]
        cols["value"] = self._value[:n]
        cols["stall"] = self._stall[:n]
        cols["outcome"] = self._outcome[:n]
        cols["req_id"] = self._req[:n]
        cols["policy_step"] = np.int64(self.policy_step)
        path = os.path.join(self.directory, shard_name(seq))
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **cols)
            f.flush()
            if self.durable:
                os.fsync(f.fileno())
        crc = _crc32_file(tmp)
        # payload first, sidecar second: a crash between the two leaves a
        # sidecar-less tail shard (torn, dropped on read), never a
        # sidecar naming a missing or half-written payload
        os.replace(tmp, path)
        side = _sidecar_path(self.directory, seq)
        stmp = f"{side}.tmp.{os.getpid()}"
        with open(stmp, "w") as f:
            json.dump({"file": shard_name(seq), "crc32": crc, "rows": n,
                       "policy_step": self.policy_step}, f)
            f.flush()
            if self.durable:
                os.fsync(f.fileno())
        os.replace(stmp, side)
        self._seq = seq + 1
        self._seq_rows += n
        self._n = 0
        if self._c_shards is not None:
            self._c_shards.inc()
        if self._bus is not None:
            # "shard", not "seq": seq is a stamp field of the bus
            self._bus.emit("flywheel_shard_seal", shard=seq, rows=n,
                           policy_step=self.policy_step)

    def seal(self) -> None:
        """Seal the buffered partial shard now (a no-op when empty)."""
        with self._lock:
            self._seal_locked()

    def close(self) -> None:
        """Seal the tail and refuse further appends (idempotent)."""
        with self._lock:
            if self._closed:
                return
            self._seal_locked()
            self._closed = True

    def __enter__(self) -> "FlightLogWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclasses.dataclass
class FlightShard:
    """One verified shard, its columns as host arrays (leaves in the
    writer's order; :func:`unflatten_like` rebuilds trees)."""
    seq: int
    path: str
    rows: int
    policy_step: int
    obs_leaves: "list[np.ndarray]"
    mask_leaves: "list[np.ndarray]"
    act_leaves: "list[np.ndarray]"
    log_prob: np.ndarray
    value: np.ndarray
    stall: np.ndarray
    outcome: np.ndarray
    req_id: "np.ndarray | None" = None


@dataclasses.dataclass
class FlightLogData:
    """A verified flight log: every shard crc-checked, a torn tail (at
    most one trailing shard without a valid sidecar) dropped and
    flagged."""
    shards: "list[FlightShard]"
    torn_tail: bool = False
    torn_reason: str = ""

    @property
    def rows(self) -> int:
        return sum(s.rows for s in self.shards)

    def concat(self) -> FlightShard:
        """All shards as one pseudo-shard (columns concatenated in seq
        order; ``policy_step`` of the oldest shard, the conservative
        staleness bound)."""
        if not self.shards:
            raise FlightLogError("empty flight log (no verified shards)")
        cat = lambda ls: [np.concatenate(x) for x in zip(*ls)]
        col = lambda k: np.concatenate([getattr(s, k) for s in self.shards])
        return FlightShard(
            seq=-1, path="<concat>", rows=self.rows,
            policy_step=min(s.policy_step for s in self.shards),
            obs_leaves=cat([s.obs_leaves for s in self.shards]),
            mask_leaves=cat([s.mask_leaves for s in self.shards]),
            act_leaves=cat([s.act_leaves for s in self.shards]),
            log_prob=col("log_prob"), value=col("value"),
            stall=col("stall"), outcome=col("outcome"),
            req_id=np.concatenate(
                [s.req_id if s.req_id is not None
                 else np.zeros(s.rows, np.int64) for s in self.shards]))


def unflatten_like(example: Any, flat: "list[np.ndarray]") -> Any:
    """Rebuild a logged tree column from an example of the same structure
    (the log stores leaves, not structures); ``None`` stays ``None``."""
    it = iter(flat)

    def build(t):
        if isinstance(t, (tuple, list)):
            items = [build(x) for x in t]
            if isinstance(t, list):
                return items
            return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        return None if t is None else next(it)

    out = build(example)
    if next(it, None) is not None:
        raise ValueError("more leaves than the example's structure holds")
    return out


def _load_shard(directory: str, seq: int, path: str) -> FlightShard:
    with open(_sidecar_path(directory, seq)) as f:
        meta = json.load(f)
    actual = _crc32_file(path)
    if actual != int(meta["crc32"]):
        raise FlightLogCorruptError(
            f"{os.path.basename(path)}: crc32 mismatch (sidecar "
            f"{int(meta['crc32']):#010x}, on disk {actual:#010x})")
    with np.load(path) as z:
        grab = lambda pre: [z[k] for k in sorted(
            (k for k in z.files if re.fullmatch(pre + r"\d+", k)),
            key=lambda k: int(k[len(pre):]))]
        shard = FlightShard(
            seq=seq, path=path, rows=int(meta["rows"]),
            policy_step=int(meta["policy_step"]),
            obs_leaves=grab("obs"), mask_leaves=grab("mask"),
            act_leaves=grab("act"), log_prob=z["log_prob"],
            value=z["value"], stall=z["stall"], outcome=z["outcome"],
            # shards written before the req_id column read as zeros
            req_id=(z["req_id"] if "req_id" in z.files
                    else np.zeros(int(meta["rows"]), np.int64)))
    if shard.rows != int(shard.log_prob.shape[0]):
        raise FlightLogCorruptError(
            f"{os.path.basename(path)}: sidecar says {shard.rows} rows, "
            f"payload has {int(shard.log_prob.shape[0])}")
    return shard


def read_flight_log(directory: str) -> FlightLogData:
    """Load and verify every shard under ``directory`` in sequence order.
    A sidecar-less or corrupt last shard is the torn tail (dropped,
    flagged); any earlier failure raises :class:`FlightLogCorruptError`.
    ``.tmp.`` leftovers (unpublished writes) are ignored."""
    directory = os.path.abspath(directory)
    found = []
    for name in os.listdir(directory):
        m = _SHARD_RE.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(directory, name)))
    found.sort()
    # the writer numbers shards 0..N-1 without holes: a gap is an interior
    # shard lost with its sidecar, which no per-file check can see
    for i, (seq, _) in enumerate(found):
        if seq != i:
            raise FlightLogCorruptError(
                f"{directory}: shard seq {i} is missing (found "
                f"{shard_name(seq)} after {i} earlier shard(s)): interior "
                f"data loss, not a torn tail")
    crc_dir = os.path.join(directory, ".crc")
    if os.path.isdir(crc_dir):
        side_seqs = sorted(
            int(m.group(1)) for m in
            (re.fullmatch(r"shard-(\d{6})\.json", n)
             for n in os.listdir(crc_dir)) if m)
        # a sidecar outlives its payload only if a sealed shard was lost
        if side_seqs and side_seqs[-1] >= len(found):
            raise FlightLogCorruptError(
                f"{directory}: sidecar for seq {side_seqs[-1]} exists but "
                f"only {len(found)} shard payload(s) remain: a sealed "
                f"shard was lost after publication")
    shards: "list[FlightShard]" = []
    torn, reason = False, ""
    for i, (seq, path) in enumerate(found):
        try:
            shards.append(_load_shard(directory, seq, path))
        except Exception as e:
            if i == len(found) - 1:
                torn = True
                reason = f"{os.path.basename(path)}: {type(e).__name__}"
                break
            if isinstance(e, FlightLogCorruptError):
                raise
            raise FlightLogCorruptError(
                f"non-tail shard {os.path.basename(path)} is unreadable "
                f"({type(e).__name__}: {e}); interior corruption, not a "
                f"torn tail") from e
    return FlightLogData(shards=shards, torn_tail=torn, torn_reason=reason)
