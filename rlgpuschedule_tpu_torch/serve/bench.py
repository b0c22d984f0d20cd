"""``serve --bench``, ``--soak`` and ``--host-path`` of the port: the
latency, sustained-load and host-path benches of the policy server.

Counterparts of ``default_request_sizes``, ``build_request_pool``,
``run_bench``, ``run_soak``, ``StubEngine``, ``_AllocCounter`` and the
in-process arms of ``run_host_path`` in the JAX package's
``serve/bench.py``. The router arms (``run_scaleout``, the soak's
autoscale loop, ``run_chaos_soak``) and the socket arms of the host
path wait for their slices.

Requests are real observations: the pool is built by resetting the
config's env windows and stepping them a few decisions under the greedy
policy being served, so the benched batches are cluster states the
policy reaches.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from ..decision import policy_decision
from ..env import env as env_lib
from ..obs.metrics import Registry
from .batching import DeadlineSheddedError, PolicyServer, next_bucket


def default_request_sizes(bucket: int) -> "tuple[int, ...]":
    """Three distinct request counts that all coalesce to ``bucket``
    (in ``(bucket/2, bucket]``): one program must serve all of them
    without a rebuild. Needs ``bucket >= 8``."""
    if bucket < 8:
        raise ValueError(f"default request sizes need bucket >= 8 for "
                         f"three distinct sizes in (bucket/2, bucket]; "
                         f"got {bucket} -- pass explicit sizes")
    return (bucket // 2 + 1, (3 * bucket) // 4, bucket)


def build_request_pool(policy: nn.Module, env_params, traces,
                       steps: int = 4,
                       ) -> "list[tuple[np.ndarray, np.ndarray]]":
    """A pool of (obs, mask) request rows: the env batch reset and
    stepped ``steps`` decisions under the greedy policy, every row a
    cluster state the policy reaches. Host rows, no leading axis; pool
    order is (step, env) row-major."""
    pool: list[tuple[np.ndarray, np.ndarray]] = []

    def rows(o, m):
        o, m = o.cpu().numpy(), m.cpu().numpy()
        pool.extend((o[i], m[i]) for i in range(o.shape[0]))

    with torch.no_grad():
        state, ts = env_lib.vec_reset(env_params, traces)
        fresh = (state, ts)
        rows(ts.obs, ts.action_mask)
        for _ in range(max(steps, 0)):
            actions = policy_decision(policy, ts.obs, ts.action_mask)
            state, ts = env_lib.vec_step(env_params, state, traces,
                                         actions, fresh=fresh)
            rows(ts.obs, ts.action_mask)
    return pool


def run_bench(engine, server: PolicyServer,
              pool: "list[tuple[np.ndarray, np.ndarray]]",
              rounds: int = 24,
              request_sizes: "tuple[int, ...] | None" = None) -> dict:
    """Serve ``rounds`` coalesced dispatches, cycling the request sizes
    and the pool deterministically, inline-pumped so every dispatch is
    exactly the round's request size. Returns the SLO report (the same
    numbers stay in the server's registry) with the steady-state
    contract: ``post_warmup_recompiles`` after the warmup of the
    buckets the sizes need, which must be 0."""
    if rounds <= 0:
        raise ValueError(f"rounds must be positive, got {rounds}")
    if not pool:
        raise ValueError("empty request pool")
    if request_sizes is None:
        request_sizes = default_request_sizes(engine.max_bucket)
    request_sizes = tuple(int(s) for s in request_sizes)
    if any(s <= 0 for s in request_sizes):
        raise ValueError(f"request sizes must be positive: "
                         f"{request_sizes}")
    buckets = sorted({engine.bucket_for(s) for s in request_sizes})

    # pre-pay the per-bucket builds: after this, any build is an alarm
    obs0, mask0 = pool[0]
    engine.warmup(obs0, mask0, buckets=tuple(buckets))
    warm_recompiles = engine.post_warmup_recompiles

    cursor = 0
    futures = []
    for r in range(rounds):
        k = request_sizes[r % len(request_sizes)]
        for _ in range(k):
            obs, mask = pool[cursor % len(pool)]
            futures.append(server.submit(obs, mask))
            cursor += 1
        server.pump()
    results = [f.result(timeout=60) for f in futures]

    snap = server.slo_snapshot()
    return {
        "rounds": rounds,
        "request_sizes": list(request_sizes),
        "buckets": [int(b) for b in buckets],
        "pool_size": len(pool),
        "post_warmup_recompiles":
            engine.post_warmup_recompiles - warm_recompiles,
        "warmed_buckets": [int(b) for b in engine.warmed_buckets],
        "graphs": bool(getattr(engine, "graphs", False)),
        **snap,
        "requests": len(results),
    }


def run_soak(server: PolicyServer,
             pool: "list[tuple[np.ndarray, np.ndarray]]", *,
             duration_s: float = 6.0, rate_hz: float = 200.0,
             deadline_s: "float | None" = None) -> dict:
    """Sustained load through a RUNNING server (the caller started its
    dispatcher): submissions paced at ``rate_hz`` for ``duration_s``,
    each with the optional ``deadline_s`` (shedding on). Reports served
    and shed counts, the rate achieved, and first-half against
    second-half p99: an unbounded queue or a leak shows as second-half
    runaway."""
    interval = 1.0 / float(rate_hz)
    futures = []
    cursor = 0
    t_start = time.perf_counter()
    next_t = t_start
    while time.perf_counter() - t_start < duration_s:
        obs, mask = pool[cursor % len(pool)]
        futures.append(server.submit(obs, mask, deadline_s=deadline_s))
        cursor += 1
        next_t += interval
        sleep = next_t - time.perf_counter()
        if sleep > 0:
            time.sleep(sleep)
    t_paced = time.perf_counter() - t_start
    lat_s: "list[float | None]" = []
    shed = 0
    for f in futures:
        try:
            lat_s.append(f.result(timeout=120).latency_s)
        except DeadlineSheddedError:
            shed += 1
            lat_s.append(None)
    wall = time.perf_counter() - t_start

    def p99_ms(xs):
        xs = [x for x in xs if x is not None]
        return (float(np.percentile(np.asarray(xs), 99) * 1e3)
                if xs else None)

    half = len(lat_s) // 2
    p99_a, p99_b = p99_ms(lat_s[:half]), p99_ms(lat_s[half:])
    return {
        "requests": len(futures),
        "served": len(futures) - shed,
        "shed": shed,
        "shed_rate": shed / max(len(futures), 1),
        "duration_s": wall,
        "rate_hz": rate_hz,
        "achieved_rate_hz": len(futures) / t_paced,
        "deadline_s": deadline_s,
        "p99_first_half_ms": p99_a,
        "p99_second_half_ms": p99_b,
        "p99_drift": (p99_b / p99_a
                      if p99_a and p99_b and p99_a > 0 else None),
    }


class StubEngine:
    """Zero-device-work engine for the host-path bench: ``decide``
    returns a view of ONE preallocated action buffer (never a fresh
    ndarray, never an alias of the caller's rows), so decisions/s
    isolates the host path: submit -> coalesce -> seal -> scatter."""

    def __init__(self, max_bucket: int = 8):
        self.max_bucket = int(max_bucket)
        self.dispatches = 0
        self.post_warmup_recompiles = 0     # nothing is built, ever
        self._actions = np.zeros(self.max_bucket, dtype=np.int32)

    def bucket_for(self, n: int) -> int:
        return next_bucket(n, self.max_bucket)

    def decide(self, obs: np.ndarray, mask: np.ndarray, stall=None):
        n = int(np.asarray(obs).shape[0])
        self.dispatches += 1
        return self._actions[:n], self.bucket_for(n)


class _AllocCounter:
    """Context manager counting calls to the numpy batch constructors
    the hot path must not touch in steady state (``zeros``, ``empty``,
    ``concatenate``, ``stack``). It wraps the module-level functions,
    so every caller in the process is counted, the legacy plane's
    ``stack_requests`` included."""

    TRACKED = ("zeros", "empty", "concatenate", "stack")

    def __init__(self):
        self.calls = 0
        self._orig: dict = {}

    def __enter__(self):
        def counted(fn):
            def inner(*a, **k):
                self.calls += 1
                return fn(*a, **k)
            return inner
        for name in self.TRACKED:
            self._orig[name] = getattr(np, name)
            setattr(np, name, counted(self._orig[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(np, name, fn)
        self._orig.clear()
        return False


def run_host_path(pool: "list[tuple[np.ndarray, np.ndarray]]", *,
                  max_bucket: int = 8, rounds: int = 300,
                  warmup_rounds: int = 12) -> dict:
    """Host-path decisions/s of the two data planes: one in-process arm
    per plane (fresh registry, :class:`StubEngine` and server,
    inline-pumped so every dispatch is exactly ``max_bucket`` rows), the
    same request stream. The measured window wraps the numpy batch
    constructors (:class:`_AllocCounter`): the legacy arm's count is the
    per-batch churn, the arena arm's must be 0, and the arena's slab
    counter must stay flat."""
    if rounds <= 0 or warmup_rounds < 1:
        raise ValueError(f"need rounds > 0 and warmup_rounds >= 1, got "
                         f"{rounds} / {warmup_rounds}")
    if not pool:
        raise ValueError("empty request pool")
    bucket = int(max_bucket)
    obs0, mask0 = pool[0]
    arms: dict[str, dict] = {}
    for plane in ("legacy", "arena"):
        reg = Registry()
        engine = StubEngine(bucket)
        server = PolicyServer(engine, registry=reg, data_plane=plane,
                              example_obs=obs0, example_mask=mask0)
        slab_allocs = reg.counter("serve_arena_allocs_total")
        cursor = 0

        # the inline pump resolves every future before the next round's
        # submits, so served rows are counted off pump()'s return and
        # the futures dropped at once (thousands of live futures would
        # measure the garbage collector, not the data plane)
        def one_round() -> int:
            nonlocal cursor
            for _ in range(bucket):
                obs, mask = pool[cursor % len(pool)]
                server.submit(obs, mask)
                cursor += 1
            return server.pump()

        # warmup: ring construction and estimators; after it any allocation in
        # the arena arm is a regression
        for _ in range(warmup_rounds):
            one_round()
        allocs_before = int(slab_allocs.value)
        requests_before = int(reg.counter("serve_requests_total").value)
        served = 0
        counter = _AllocCounter()
        t0 = time.perf_counter()
        with counter:
            for _ in range(rounds):
                served += one_round()
        wall = time.perf_counter() - t0
        submitted = (int(reg.counter("serve_requests_total").value)
                     - requests_before)
        shed = int(reg.counter("serve_shed_total").value)
        server.close()
        arms[plane] = {
            "data_plane": plane,
            "requests": submitted,
            "served": served,
            "shed": shed,
            "conservation_ok": submitted == served + shed,
            "decisions_per_s": served / wall,
            "wall_s": wall,
            "dispatches": engine.dispatches,
            "alloc_calls": counter.calls,
            "allocs_per_batch": counter.calls / rounds,
            "steady_state_slab_allocs":
                int(slab_allocs.value) - allocs_before,
            "post_warmup_recompiles": engine.post_warmup_recompiles,
            "arena": server.arena_stats() if plane == "arena" else None,
        }
    out = {
        "bucket": bucket,
        "rounds": rounds,
        "warmup_rounds": warmup_rounds,
        "requests_per_arm": rounds * bucket,
        "paced": False,
        "arrival_fit": None,
        "rate_hz": None,
        "caveat": ("stub engine, zero device work: decisions/s is the "
                   "HOST path only (submit/coalesce/seal/scatter)"),
        "arms": [arms["legacy"], arms["arena"]],
    }
    base = arms["legacy"]["decisions_per_s"]
    out["speedup_inproc"] = (arms["arena"]["decisions_per_s"] / base
                             if base > 0 else None)
    out["speedup"] = out["speedup_inproc"]
    return out
