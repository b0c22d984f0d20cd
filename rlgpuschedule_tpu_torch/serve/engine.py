"""Bucketed greedy inference engine (L6) of the port, one CUDA graph
per bucket.

Counterpart of the JAX package's ``serve/engine.py``. ``decide`` takes a
host batch of requests ``[n, ...]`` (an array, or a tree of arrays such
as the hierarchical env's ``{"top", "pods"}`` observations), writes it
leaf by leaf into the bucket's pinned staging buffers (the tail padded
in place: zero observations, masks with every action legal, zero stall
counts), uploads it with ``non_blocking`` copies, runs the greedy
decision rule (:func:`..decision.policy_decision`, the one
:func:`..eval.replay` uses) and downloads the actions into preallocated
host buffers: an ``i32`` array, or a dict of per-head ``i32`` arrays
for the hierarchical policy (whose pods cannot preempt: no stall gate).

**Programs.** The JAX engine compiles one XLA program per power-of-two
bucket. Here a program is keyed by the bucket and the request rows'
structure, shapes and dtypes. On a CUDA device, a key's first dispatch
warms the decision on a side stream, captures it -- the stall gate
(:func:`..decision.gate_stalled`, when the engine is given
``env_params`` of a preemptive action space) and ``policy_decision`` --
as a CUDA graph reading static device input buffers and writing static
output buffers, and every later dispatch copies into those inputs and
replays the graph. On the CPU the first dispatch of a key allocates its
buffers and the decision runs eagerly (the plain version; there is no
graph). ``engine.graphs`` says which of the two runs. A capture or
replay that fails raises: on the card the engine never falls back to
eager dispatch. ``eager=True`` on a CUDA device asks for the eager
decision on the card instead, the plain version a graph is held
against.

**Streams.** On the card a routed engine (``engine_id`` given) owns a
CUDA stream for its uploads, replays and downloads, so N engines of a
router share one card without sharing a queue; a lone engine has no
other engine to overlap with and keeps the caller's current stream,
paying no stream switch per call. Each graph has its own memory pool. A
capture runs in ``capture_error_mode="thread_local"``, so calls of
other threads cannot invalidate it (the router also holds its other
engines quiet while it spins one up). The download waits on an event,
not on the stream, so no dispatch makes a call the sync guard forbids.

**Sentinels.** The first dispatch of a key is its blessed build
(``serve_bucket_compiles_total``, a ``compile`` event on the bus).
A dispatch at a warmed bucket whose key was never built is a
**recompile alarm**: ``serve_recompile_alarms_total`` goes up, a
``recompile`` event is emitted, and under ``strict`` the dispatch
raises :class:`..analysis.sentinels.RecompileSentinelError` before it
builds anything. ``engine_id=`` labels both series (``{engine="i"}``),
so the N engines of a router keep N counters in one registry. Every
build is also reported to :class:`..analysis.sentinels.CompileCounter`.
The upload, replay and download run under
:func:`..analysis.sentinels.no_implicit_transfers` (torch's sync debug
mode set to raise, refcounted across the dispatcher threads), the wait
for the download's event outside it.

**Weights** swap in place (:meth:`InferenceEngine.set_params` copies
into the parameters' storage, which the graphs read, with non-blocking
copies on the engine's stream), and :meth:`InferenceEngine.rewarm`
replays a neutral batch through every warmed bucket, capturing nothing.

**Threads.** One lock guards each dispatch from staging to download, so
two threads never interleave on a key's buffers; ``decide`` copies the
actions out of the key's download buffers under that lock, so a later
dispatch or :meth:`InferenceEngine.rewarm` never overwrites what a
caller holds.

**Capture mode** (``capture=True``, the flywheel's tap): the program
decides through :func:`..decision.policy_decision_full`, so the same
graph also writes the greedy action's joint log-prob and the value
(f32 per row), downloaded by the same non-blocking copies and event as
the actions; ``decide`` then returns ``((actions, log_prob, value),
bucket)``, as the JAX engine does. The actions come from the same
masked logits and argmax as the plain engine's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch
from torch import nn

from ..analysis.sentinels import (BUILD, CAPTURE, RecompileSentinelError,
                                  no_implicit_transfers, note_build)
from ..decision import (gate_stalled, policy_decision,
                        policy_decision_full, preempt_slice, stall_threshold)
from ..device import resolve_device
from ..obs.metrics import Registry
from ..obs.trace import NULL_TRACER
from ..tree import leaves, structure, tree_map, unflatten
from .batching import next_bucket

# side-stream runs of the decision before a capture (allocator, cuBLAS
# and cuDNN handles and workspaces), as torch.cuda.graphs asks
WARM_RUNS = 3


@dataclasses.dataclass
class _Program:
    """One key's buffers: host staging (pinned on a CUDA device) and
    their numpy views, one per obs leaf, mask leaf and (with the stall
    gate) the stall lane; the device inputs (the staging buffers
    themselves on the CPU); the outputs (an i32 tensor, or a dict of
    them per head; in capture mode with the f32 log-prob and value
    beside them), their host download buffers and numpy views (the same
    structure), and the graph."""
    staging: "tuple[torch.Tensor, ...]"
    staging_np: "tuple[np.ndarray, ...]"
    inputs: "tuple[torch.Tensor, ...]"
    out: object = None
    host_out: object = None
    host_out_np: object = None
    graph: "torch.cuda.CUDAGraph | None" = None


class InferenceEngine:
    """Bucketed greedy policy inference on one device, one program (a
    CUDA graph on the card) per bucket and row signature."""

    def __init__(self, policy: nn.Module, max_bucket: int = 256,
                 device: "torch.device | str | None" = None,
                 env_params=None, registry: "Registry | None" = None,
                 bus=None, strict: bool = False, tracer=None,
                 capture: bool = False, eager: bool = False,
                 engine_id: "int | None" = None):
        if max_bucket <= 0 or (max_bucket & (max_bucket - 1)):
            raise ValueError(f"max_bucket must be a positive power of "
                             f"two, got {max_bucket}")
        self.capture = bool(capture)
        self.device = resolve_device(device)
        cuda = self.device.type == "cuda"
        self.graphs = cuda and not eager
        for name, p in policy.state_dict().items():
            if p.device.type != self.device.type:
                raise ValueError(
                    f"policy parameter {name!r} lives on {p.device}, the "
                    f"engine serves {self.device}; move the policy first")
        self.policy = policy
        self.max_bucket = max_bucket
        self.strict = strict
        self.engine_id = engine_id
        self.registry = registry if registry is not None else Registry()
        self._bus = bus
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._pin = cuda
        # a routed engine's own queue on the card (module docstring)
        self._stream = (torch.cuda.Stream(self.device)
                        if cuda and engine_id is not None else None)
        self._done = torch.cuda.Event() if cuda else None
        # the gate's preempt slice, built once on the serving device
        self._pre = (preempt_slice(env_params, self.device)
                     if env_params is not None else None)
        self._thresh = (stall_threshold(env_params)
                        if self._pre is not None else 0)
        self._programs: dict[tuple, _Program] = {}
        self._warmed: set[int] = set()
        self._example = None
        self._lock = threading.Lock()
        labels = ({"engine": str(engine_id)} if engine_id is not None
                  else None)
        self._recompiles = self.registry.counter(
            "serve_recompile_alarms_total",
            "post-warmup dispatches that needed a new program (a "
            "CUDA-graph capture on the card)", labels=labels)
        self._compiles = self.registry.counter(
            "serve_bucket_compiles_total",
            "blessed per-bucket program builds (CUDA-graph captures on "
            "the card)", labels=labels)

    @property
    def devices(self) -> "tuple[torch.device, ...]":
        """The devices this engine serves from (one)."""
        return (self.device,)

    @property
    def post_warmup_recompiles(self) -> int:
        return int(self._recompiles.value)

    @property
    def warmed_buckets(self) -> "tuple[int, ...]":
        return tuple(sorted(self._warmed))

    def bucket_for(self, n: int) -> int:
        return next_bucket(n, self.max_bucket)

    def set_params(self, state_dict: "dict[str, torch.Tensor]") -> None:
        """Swap the served weights in place: the new weights must have
        the incumbent's names, shapes and dtypes, and are copied into
        the parameters' existing storage, which the captured graphs
        read. Anything else is a redeploy, and is refused. On the card
        the copies are non-blocking on the engine's stream (a pageable
        or blocking copy would trip another dispatcher's sync guard)."""
        old = self.policy.state_dict()
        if set(old) != set(state_dict):
            raise ValueError(
                f"param swap changed the parameter names (missing "
                f"{sorted(set(old) - set(state_dict))}, unexpected "
                f"{sorted(set(state_dict) - set(old))}); redeploy instead")
        for k, a in old.items():
            b = state_dict[k]
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(
                    f"param swap changed {k!r} from {tuple(a.shape)}/"
                    f"{a.dtype} to {tuple(b.shape)}/{b.dtype}; redeploy "
                    f"instead")
        with self._lock:
            if self._done is None:
                # load_state_dict copies into the existing tensors
                self.policy.load_state_dict(state_dict)
                return
            caller = torch.cuda.current_stream(self.device)
            with torch.no_grad(), self._on_stream():
                torch.cuda.current_stream(self.device).wait_stream(caller)
                for k, a in old.items():
                    b = state_dict[k]
                    a.copy_(b.pin_memory() if b.device.type == "cpu" else b,
                            non_blocking=True)
                self._done.record()
            self._done.synchronize()

    def rewarm(self) -> "tuple[int, ...]":
        """Blessed re-warm after a :meth:`set_params` swap: one neutral
        batch through every warmed bucket before live traffic. The
        programs exist, so this builds and captures nothing; a build
        here hits a warmed bucket and is a recompile alarm. Needs a
        prior :meth:`warmup` (its example shapes the batches)."""
        if self._example is None:
            raise RuntimeError(
                "rewarm() needs the example request stored by warmup(); "
                "warm the engine before swapping params")
        driven = []
        for b in self.warmed_buckets:
            self.decide(*self._neutral(b))
            driven.append(b)
        return tuple(driven)

    def _on_stream(self):
        """The engine's own stream as the current one (a routed engine),
        else the caller's, unchanged."""
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _emit(self, kind: str, **fields) -> None:
        if self._bus is not None:
            self._bus.emit(kind, **fields)

    def _neutral(self, bucket: int):
        obs, mask = self._example
        return (tree_map(lambda x: np.zeros((bucket,) + x.shape, x.dtype),
                         obs),
                tree_map(lambda x: np.ones((bucket,) + x.shape, x.dtype),
                         mask),
                np.zeros(bucket, np.int32))

    def _decision(self, prog: _Program, obs_like, mask_like, n_obs: int):
        """The served rule on the key's device inputs: i32 actions (a
        dict of per-head i32 actions for the hierarchical policy); in
        capture mode the triple ``(actions, log_prob, value)``."""
        n_mask = len(leaves(mask_like))
        obs = unflatten(obs_like, prog.inputs[:n_obs])
        mask = unflatten(mask_like, prog.inputs[n_obs:n_obs + n_mask])
        if self._pre is not None:
            mask = gate_stalled(mask, prog.inputs[-1], self._thresh,
                                self._pre)
        i32 = lambda a: a.to(torch.int32)
        if self.capture:
            actions, log_prob, value = policy_decision_full(self.policy,
                                                            obs, mask)
            return tree_map(i32, actions), log_prob, value
        return tree_map(i32, policy_decision(self.policy, obs, mask))

    def _buffers(self, bucket: int, rows: "list[np.ndarray]") -> _Program:
        """Allocate a key's input buffers (its first dispatch only)."""
        shapes = [(bucket,) + x.shape[1:] for x in rows]
        dtypes = [torch.from_numpy(x[:0]).dtype for x in rows]
        if self._pre is not None:
            shapes.append((bucket,))
            dtypes.append(torch.int32)
        staging = tuple(torch.empty(s, dtype=d, pin_memory=self._pin)
                        for s, d in zip(shapes, dtypes))
        inputs = (staging if self.device.type == "cpu" else
                  tuple(torch.empty(s, dtype=d, device=self.device)
                        for s, d in zip(shapes, dtypes)))
        return _Program(staging=staging,
                        staging_np=tuple(t.numpy() for t in staging),
                        inputs=inputs)

    def _capture(self, prog: _Program, decision) -> None:
        """Warm the decision on a side stream, then capture it (the
        staged request already uploaded into the static inputs)."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side), torch.no_grad():
            for _ in range(WARM_RUNS):
                decision()
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            prog.out = decision()
        prog.graph = graph

    def _stage(self, prog: _Program, rows: "list[np.ndarray]", n_obs: int,
               stall, n: int) -> None:
        """Host rows into the staging buffers, the tail padded in place
        (slice assignment: no batch is allocated)."""
        for j, x in enumerate(rows):
            dst = prog.staging_np[j]
            dst[:n] = x
            if n < dst.shape[0]:
                dst[n:] = True if (j >= n_obs and dst.dtype == np.bool_) \
                    else 0
        if self._pre is not None:
            s = prog.staging_np[-1]
            s[:n] = 0 if stall is None else stall
            s[n:] = 0

    def _host_out(self, prog: _Program) -> None:
        """The download buffers of a key's outputs (its first dispatch
        only): pinned on the card, so the download is non-blocking."""
        prog.host_out = tree_map(lambda o: torch.empty(
            o.shape, dtype=o.dtype, pin_memory=self._pin), prog.out)
        prog.host_out_np = tree_map(lambda h: h.numpy(), prog.host_out)

    def decide(self, obs, mask, stall: "np.ndarray | None" = None):
        """Decide one request batch: ``obs``/``mask`` are host arrays, or
        trees of them, with a leading request axis; ``stall`` is
        ``i32[n]`` consecutive zero-dt steps per request (zeros if None;
        ignored unless the action space has preempt actions to gate).
        Returns ``(i32 actions[:n], bucket)`` (a dict of per-head
        actions for the hierarchical policy), in capture mode
        ``((actions[:n], log_prob[:n], value[:n]), bucket)``; the arrays
        are the caller's own copies."""
        obs_l = [np.asarray(x) for x in leaves(obs)]
        mask_l = [np.asarray(x) for x in leaves(mask)]
        n = int(obs_l[0].shape[0])
        bucket = self.bucket_for(n)
        # the rows' signature: structure, and each leaf's shape and dtype
        key = (bucket, structure(obs),
               tuple((x.shape[1:], x.dtype.str) for x in obs_l),
               structure(mask),
               tuple((x.shape[1:], x.dtype.str) for x in mask_l))
        rows = obs_l + mask_l
        with self._lock:
            prog = self._programs.get(key)
            built = prog is None
            blessed = bucket not in self._warmed
            if built:
                if not blessed:
                    self._alarm(bucket, key)
                prog = self._buffers(bucket, rows)
            with self.tracer.span("pad", n=n, bucket=bucket):
                self._stage(prog, rows, len(obs_l), stall, n)

            def decision():
                return self._decision(prog, obs, mask, len(obs_l))
            with self.tracer.span("dispatch", bucket=bucket):
                if self._done is None:
                    if built:
                        self._build(prog, bucket, blessed, decision)
                    with torch.no_grad():
                        prog.out = decision()
                    if prog.host_out is None:
                        self._host_out(prog)
                    for h, o in zip(leaves(prog.host_out),
                                    leaves(prog.out)):
                        h.copy_(o)
                else:
                    with self._on_stream():
                        if built:
                            self._build(prog, bucket, blessed, decision)
                        self._dispatch(prog, decision)
                    # outside the guard: wait for the download (and so for
                    # the upload: the staging buffers are free again)
                    self._done.synchronize()
            if built:
                self._programs[key] = prog
            self._warmed.add(bucket)
            # copied under the lock: the download buffers are the key's,
            # and the next dispatch there overwrites them
            return tree_map(lambda h: h[:n].copy(), prog.host_out_np), bucket

    def _dispatch(self, prog: _Program, decision) -> None:
        """Upload, replay (or the eager decision) and the download's
        enqueue on the engine's stream, under the sync guard."""
        with no_implicit_transfers(self.device):
            for d, h in zip(prog.inputs, prog.staging):
                d.copy_(h, non_blocking=True)
            if prog.graph is not None:
                prog.graph.replay()
            else:
                with torch.no_grad():
                    prog.out = decision()
                if prog.host_out is None:
                    self._host_out(prog)
            for h, o in zip(leaves(prog.host_out), leaves(prog.out)):
                h.copy_(o, non_blocking=True)
            self._done.record()

    def _alarm(self, bucket: int, key: tuple) -> None:
        """A key never built, at a warmed bucket."""
        self._recompiles.inc()
        self._emit("recompile", scope="serve", bucket=bucket,
                   rows=repr(key[1:]))
        if self.strict:
            raise RecompileSentinelError(
                f"serving dispatch at warmed bucket {bucket} needs a new "
                f"program for rows {key[1:]}: a steady-state policy "
                f"server must never recompile")

    def _build(self, prog: _Program, bucket: int, blessed: bool,
               decision) -> None:
        """A key's build: on the card the upload of the staged request,
        the capture and the download buffers (or, with ``eager=True``,
        the upload alone); on the CPU nothing more (the buffers are the
        build). Counted as a blessed compile at a bucket's first
        dispatch; at a warmed bucket the alarm has counted it already."""
        if self.graphs:
            for d, h in zip(prog.inputs, prog.staging):
                d.copy_(h, non_blocking=True)
            self._capture(prog, decision)
            self._host_out(prog)
        kind = CAPTURE if self.graphs else BUILD
        note_build(kind)
        if blessed:
            self._compiles.inc()
            self._emit("compile", scope="serve", bucket=bucket,
                       program=kind)

    def warmup(self, example_obs, example_mask,
               buckets: "tuple[int, ...]" = ()) -> "tuple[int, ...]":
        """Build each bucket's program with one neutral batch (every
        power of two up to ``max_bucket`` by default), so that no live
        dispatch builds. ``example_*`` are one request (an array or a
        tree of arrays), no leading axis; the engine keeps them for
        :meth:`rewarm`. Returns the buckets warmed by this call."""
        self._example = (tree_map(np.asarray, example_obs),
                         tree_map(np.asarray, example_mask))
        if not buckets:
            buckets = tuple(1 << i
                            for i in range(self.max_bucket.bit_length()))
        done = []
        for b in sorted(set(buckets)):
            if b != next_bucket(b, self.max_bucket):
                raise ValueError(f"bucket {b} is not a power of two "
                                 f"<= max_bucket={self.max_bucket}")
            if b in self._warmed:
                continue
            self.decide(*self._neutral(b))
            done.append(b)
        return tuple(done)
