"""Bucketed greedy inference engine (L6) of the port, one CUDA graph
per bucket.

Counterpart of the JAX package's ``serve/engine.py``. ``decide`` takes a
host batch of requests ``[n, ...]``, writes it into the bucket's pinned
staging buffers (the tail padded in place: zero observations, masks
with every action legal, zero stall counts), uploads it with
``non_blocking`` copies, runs the greedy decision rule
(:func:`..decision.policy_decision`, the one :func:`..eval.replay`
uses) and downloads the actions into a preallocated host buffer.

**Programs.** The JAX engine compiles one XLA program per power-of-two
bucket. Here a program is keyed by the bucket and the request rows'
shapes and dtypes. On a CUDA device, a key's first dispatch warms the
decision on a side stream, captures it -- the stall gate
(:func:`..decision.gate_stalled`, when the engine is given
``env_params``) and ``policy_decision`` -- as a CUDA graph reading
static device input buffers and writing a static output buffer, and
every later dispatch copies into those inputs and replays the graph.
On the CPU the first dispatch of a key allocates its buffers and the
decision runs eagerly (the plain version; there is no graph).
``engine.graphs`` says which of the two runs. A capture or replay that
fails raises: on the card the engine never falls back to eager
dispatch. ``eager=True`` on a CUDA device asks for the eager decision
on the card instead, the plain version a graph is held against.

**Sentinels.** The first dispatch of a key is its blessed build
(``serve_bucket_compiles_total``, a ``compile`` event on the bus).
A dispatch at a warmed bucket whose key was never built is a
**recompile alarm**: ``serve_recompile_alarms_total`` goes up, a
``recompile`` event is emitted, and under ``strict`` the dispatch
raises :class:`..analysis.sentinels.RecompileSentinelError` before it
builds anything. Every build is also reported to
:class:`..analysis.sentinels.CompileCounter`. The upload and replay run
under :func:`..analysis.sentinels.no_implicit_transfers` (torch's sync
debug mode set to raise), the download outside it.

**Weights** swap in place (:meth:`InferenceEngine.set_params` copies
into the parameters' storage, which the graphs read), and
:meth:`InferenceEngine.rewarm` replays a neutral batch through every
warmed bucket, capturing nothing.

**Threads.** One lock guards each dispatch from staging to download, so
two threads never interleave on a key's buffers; ``decide`` copies the
actions out of the key's download buffer under that lock, so a later
dispatch or :meth:`InferenceEngine.rewarm` never overwrites what a
caller holds. The sync guard is process-wide, so one thread
dispatches per engine.

Capture mode (the behavior log-prob and value of the flywheel) waits
for its slice.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch
from torch import nn

from ..analysis.sentinels import (BUILD, CAPTURE, RecompileSentinelError,
                                  no_implicit_transfers, note_build)
from ..decision import (gate_stalled, policy_decision, preempt_slice,
                        stall_threshold)
from ..device import resolve_device
from ..obs.metrics import Registry
from ..obs.trace import NULL_TRACER
from .batching import next_bucket

# side-stream runs of the decision before a capture (allocator, cuBLAS
# and cuDNN handles and workspaces), as torch.cuda.graphs asks
WARM_RUNS = 3


@dataclasses.dataclass
class _Program:
    """One key's buffers: host staging (pinned on a CUDA device) and
    their numpy views, the device inputs (the staging buffers themselves
    on the CPU), the output, the host download buffer, and the graph."""
    staging: "tuple[torch.Tensor, ...]"
    staging_np: "tuple[np.ndarray, ...]"
    inputs: "tuple[torch.Tensor, ...]"
    host_out: torch.Tensor
    host_out_np: np.ndarray
    out: "torch.Tensor | None" = None
    graph: "torch.cuda.CUDAGraph | None" = None


class InferenceEngine:
    """Bucketed greedy policy inference on one device, one program (a
    CUDA graph on the card) per bucket and row signature."""

    def __init__(self, policy: nn.Module, max_bucket: int = 256,
                 device: "torch.device | str | None" = None,
                 env_params=None, registry: "Registry | None" = None,
                 bus=None, strict: bool = False, tracer=None,
                 capture: bool = False, eager: bool = False):
        if max_bucket <= 0 or (max_bucket & (max_bucket - 1)):
            raise ValueError(f"max_bucket must be a positive power of "
                             f"two, got {max_bucket}")
        if capture:
            raise NotImplementedError(
                "capture=True (the behavior log-prob and value of the "
                "flight log) waits for the flywheel slice (ROADMAP.md "
                "queue 1, item 23)")
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
        self.registry = registry if registry is not None else Registry()
        self._bus = bus
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._pin = cuda
        # the gate's preempt slice, built once on the serving device
        self._pre = (preempt_slice(env_params, self.device)
                     if env_params is not None else None)
        self._thresh = (stall_threshold(env_params)
                        if self._pre is not None else 0)
        self._programs: dict[tuple, _Program] = {}
        self._warmed: set[int] = set()
        self._example: "tuple[np.ndarray, np.ndarray] | None" = None
        self._lock = threading.Lock()
        self._recompiles = self.registry.counter(
            "serve_recompile_alarms_total",
            "post-warmup dispatches that needed a new program (a "
            "CUDA-graph capture on the card)")
        self._compiles = self.registry.counter(
            "serve_bucket_compiles_total",
            "blessed per-bucket program builds (CUDA-graph captures on "
            "the card)")

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
        read. Anything else is a redeploy, and is refused."""
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
            # load_state_dict copies into the existing tensors
            self.policy.load_state_dict(state_dict)

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

    def _emit(self, kind: str, **fields) -> None:
        if self._bus is not None:
            self._bus.emit(kind, **fields)

    def _neutral(self, bucket: int):
        obs, mask = self._example
        return (np.zeros((bucket,) + obs.shape, obs.dtype),
                np.ones((bucket,) + mask.shape, mask.dtype),
                np.zeros(bucket, np.int32))

    def _decision(self, prog: _Program) -> torch.Tensor:
        """The served rule on the key's device inputs: i32 actions."""
        obs, mask = prog.inputs[0], prog.inputs[1]
        if self._pre is not None:
            mask = gate_stalled(mask, prog.inputs[2], self._thresh,
                                self._pre)
        return policy_decision(self.policy, obs, mask).to(torch.int32)

    def _buffers(self, bucket: int, obs: np.ndarray,
                 mask: np.ndarray) -> _Program:
        """Allocate a key's buffers (its first dispatch only)."""
        shapes = [(bucket,) + obs.shape[1:], (bucket,) + mask.shape[1:]]
        dtypes = [torch.from_numpy(obs[:0]).dtype,
                  torch.from_numpy(mask[:0]).dtype]
        if self._pre is not None:
            shapes.append((bucket,))
            dtypes.append(torch.int32)
        staging = tuple(torch.empty(s, dtype=d, pin_memory=self._pin)
                        for s, d in zip(shapes, dtypes))
        inputs = (staging if self.device.type == "cpu" else
                  tuple(torch.empty(s, dtype=d, device=self.device)
                        for s, d in zip(shapes, dtypes)))
        host_out = torch.empty(bucket, dtype=torch.int32,
                               pin_memory=self._pin)
        return _Program(staging=staging,
                        staging_np=tuple(t.numpy() for t in staging),
                        inputs=inputs, host_out=host_out,
                        host_out_np=host_out.numpy())

    def _capture(self, prog: _Program) -> None:
        """Warm the decision on a side stream, then capture it (the
        staged request already uploaded into the static inputs)."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side), torch.no_grad():
            for _ in range(WARM_RUNS):
                self._decision(prog)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(graph):
            prog.out = self._decision(prog)
        prog.graph = graph

    def _stage(self, prog: _Program, obs: np.ndarray, mask: np.ndarray,
               stall, n: int) -> None:
        """Host rows into the staging buffers, the tail padded in place
        (slice assignment: no batch is allocated)."""
        o, m = prog.staging_np[0], prog.staging_np[1]
        o[:n] = obs
        m[:n] = mask
        if n < o.shape[0]:
            o[n:] = 0
            m[n:] = True if m.dtype == np.bool_ else 0
        if self._pre is not None:
            s = prog.staging_np[2]
            s[:n] = 0 if stall is None else stall
            s[n:] = 0

    def decide(self, obs: np.ndarray, mask: np.ndarray,
               stall: "np.ndarray | None" = None,
               ) -> "tuple[np.ndarray, int]":
        """Decide one request batch: ``obs``/``mask`` are host arrays
        with a leading request axis; ``stall`` is ``i32[n]`` consecutive
        zero-dt steps per request (zeros if None; ignored unless the
        action space has preempt actions to gate). Returns ``(i32
        actions[:n], bucket)``; the actions are the caller's own copy."""
        obs, mask = np.asarray(obs), np.asarray(mask)
        n = int(obs.shape[0])
        bucket = self.bucket_for(n)
        key = (bucket, obs.shape[1:], obs.dtype.str, mask.shape[1:],
               mask.dtype.str)
        with self._lock:
            prog = self._programs.get(key)
            built = prog is None
            blessed = bucket not in self._warmed
            if built:
                if not blessed:
                    self._alarm(bucket, key)
                prog = self._buffers(bucket, obs, mask)
            with self.tracer.span("pad", n=n, bucket=bucket):
                self._stage(prog, obs, mask, stall, n)
            with self.tracer.span("dispatch", bucket=bucket):
                if built:
                    self._build(prog, bucket, blessed)
                if self.device.type == "cpu":
                    with torch.no_grad():
                        prog.out = self._decision(prog)
                else:
                    with no_implicit_transfers(self.device):
                        for d, h in zip(prog.inputs, prog.staging):
                            d.copy_(h, non_blocking=True)
                        if prog.graph is not None:
                            prog.graph.replay()
                        else:
                            with torch.no_grad():
                                prog.out = self._decision(prog)
                # the explicit download, outside the sync guard; it
                # waits for the decision and so for the upload: the
                # staging buffers are free again when it returns
                prog.host_out.copy_(prog.out)
            if built:
                self._programs[key] = prog
            self._warmed.add(bucket)
            # copied under the lock: the download buffer is the key's,
            # and the next dispatch there overwrites it
            return prog.host_out_np[:n].copy(), bucket

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

    def _build(self, prog: _Program, bucket: int, blessed: bool) -> None:
        """A key's build: on the card the upload of the staged request
        and the capture (or, with ``eager=True``, nothing more); on
        the CPU nothing more (the buffers are the build). Counted as a
        blessed compile at a bucket's first dispatch; at a warmed bucket
        the alarm has counted it already."""
        if self.graphs:
            for d, h in zip(prog.inputs, prog.staging):
                d.copy_(h)
            self._capture(prog)
        kind = CAPTURE if self.graphs else BUILD
        note_build(kind)
        if blessed:
            self._compiles.inc()
            self._emit("compile", scope="serve", bucket=bucket,
                       program=kind)

    def warmup(self, example_obs: np.ndarray, example_mask: np.ndarray,
               buckets: "tuple[int, ...]" = ()) -> "tuple[int, ...]":
        """Build each bucket's program with one neutral batch (every
        power of two up to ``max_bucket`` by default), so that no live
        dispatch builds. ``example_*`` are one request, no leading axis;
        the engine keeps them for :meth:`rewarm`. Returns the buckets
        warmed by this call."""
        self._example = (np.asarray(example_obs), np.asarray(example_mask))
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
