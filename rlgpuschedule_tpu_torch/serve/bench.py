"""``serve --bench``, ``--soak``, ``--scaleout`` and ``--host-path`` of
the port: the latency, sustained-load, scale-out, chaos and host-path
benches of the policy server.

Counterparts of ``default_request_sizes``, ``build_request_pool``,
``run_bench``, ``run_scaleout``, ``run_soak`` (with the router's
autoscale loop), ``fit_paced_gaps``, ``run_chaos_soak``, ``StubEngine``,
``_AllocCounter``, ``_run_wire_arm`` and ``run_host_path`` (its
in-process arms, and with ``wire_requests`` its two socket arms through
the front door) in the JAX package's ``serve/bench.py``.

Requests are real observations: the pool is built by resetting the
config's env windows and stepping them a few decisions under the greedy
policy being served, so the benched batches are cluster states the
policy reaches (dict rows for the hierarchical env).

The scale-out and soak reports carry what limits their engine arms: on
the CPU the router serializes device work (``serialized_dispatch_cpu``,
as JAX's does), and on one card the engines share it, so decisions/s
measures how far their dispatches overlap there, not N cards.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch
from torch import nn

from ..decision import policy_decision
from ..env import hier as env_hier
from ..obs.metrics import Registry
from ..tree import index, leaves, tree_map
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
                       steps: int = 4, faults=None) -> "list[tuple]":
    """A pool of (obs, mask) request rows: the env batch reset and
    stepped ``steps`` decisions under the greedy policy (and the batched
    fault schedules ``faults`` of a flat env), every row a cluster state
    the policy reaches. Host rows (arrays, or dicts of arrays for the
    hierarchical env), no leading axis; pool order is (step, env)
    row-major."""
    pool: list[tuple] = []
    env = env_hier.env_module(env_params)

    def rows(o, m):
        o = tree_map(lambda x: x.cpu().numpy(), o)
        m = tree_map(lambda x: x.cpu().numpy(), m)
        n = leaves(o)[0].shape[0]
        pool.extend((index(o, i), index(m, i)) for i in range(n))

    with torch.no_grad():
        state, ts = env.vec_reset(env_params, traces, faults)
        step = env_hier.vec_stepper(env_params, traces, faults)
        fresh = (state, ts)
        rows(ts.obs, ts.action_mask)
        for _ in range(max(steps, 0)):
            actions = policy_decision(policy, ts.obs, ts.action_mask)
            state, ts = step(state, actions, fresh)
            rows(ts.obs, ts.action_mask)
    return pool


def run_bench(engine, server: PolicyServer,
              pool: "list[tuple]",
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


def _caveat(router) -> "str | None":
    """What limits a router's engine arms on this rig, or None."""
    if router.serialized_dispatch():
        return ("CPU: the router serializes device dispatch behind one "
                "lock, so decisions/s does not scale with engines here; "
                "routing, occupancy and shed accounting is what this "
                "measures")
    if len(router.devices) < router.n_engines:
        return (f"{router.n_engines} engines share "
                f"{len(router.devices)} device(s) "
                f"({', '.join(str(d) for d in router.devices)}) and one "
                f"interpreter: decisions/s scales only as far as their "
                f"dispatches overlap there")
    return None


def run_scaleout(policy: nn.Module, env_params, pool: "list[tuple]", *,
                 max_bucket: int, rounds: int = 24,
                 request_sizes: "tuple[int, ...] | None" = None,
                 engine_counts: "tuple[int, ...]" = (1, 2),
                 deadline_s: "float | None" = None,
                 device: "torch.device | str | None" = None) -> dict:
    """Decisions/s and shed rate against engine count: one isolated arm
    per count in ``engine_counts`` (a fresh router, registry and server,
    so arms share nothing), each serving the SAME deterministic request
    stream through as many live dispatcher threads as engines. Every
    arm's engines are warmed at every bucket, one after another, before
    its dispatchers start (live batches coalesce to any bucket; JAX's
    warms only the request sizes' buckets). Per arm: per-engine rows, row shares, dispatches, occupancy
    and recompiles; at the top level the caveat of what limits the arms
    (:func:`_caveat`)."""
    from .router import EngineRouter

    if request_sizes is None:
        request_sizes = default_request_sizes(max_bucket)
    request_sizes = tuple(int(s) for s in request_sizes)
    obs0, mask0 = pool[0]
    arms = []
    serialized, caveat = None, None
    for k in engine_counts:
        reg = Registry()
        router = EngineRouter(policy, env_params, max_bucket=max_bucket,
                              registry=reg, n_engines=int(k), device=device)
        serialized = router.serialized_dispatch()
        caveat = _caveat(router) or caveat
        router.warmup(obs0, mask0)
        server = PolicyServer(router, registry=reg)
        server.start(dispatchers=int(k))
        futures, shed, cursor = [], 0, 0
        try:
            t0 = time.perf_counter()
            for r in range(rounds):
                for _ in range(request_sizes[r % len(request_sizes)]):
                    obs, mask = pool[cursor % len(pool)]
                    futures.append(server.submit(obs, mask,
                                                 deadline_s=deadline_s))
                    cursor += 1
            for f in futures:
                try:
                    f.result(timeout=120)
                except DeadlineSheddedError:
                    shed += 1
            wall = time.perf_counter() - t0
        finally:
            server.stop()
        stats = router.stats()
        total_rows = sum(st.rows for st in stats) or 1
        arms.append({
            "engines": int(k),
            "requests": len(futures),
            "served": len(futures) - shed,
            "shed": shed,
            "shed_rate": shed / len(futures),
            "decisions_per_s": (len(futures) - shed) / wall,
            "wall_s": wall,
            "dispatches": int(reg.counter("serve_dispatches_total").value),
            "per_engine_rows": [st.rows for st in stats],
            "per_engine_row_share": [st.rows / total_rows for st in stats],
            "per_engine_dispatches": [st.dispatches for st in stats],
            "per_engine_occupancy": [st.occupancy for st in stats],
            "per_engine_recompiles": router.per_engine_recompiles(),
        })
        server.close()
    return {
        "engine_counts": [int(k) for k in engine_counts],
        "rounds": rounds,
        "request_sizes": list(request_sizes),
        "deadline_s": deadline_s,
        "serialized_dispatch_cpu": bool(serialized),
        "caveat": caveat,
        "arms": arms,
    }


def _p99_ms(xs: "list[float | None]") -> "float | None":
    xs = [x for x in xs if x is not None]
    return float(np.percentile(np.asarray(xs), 99) * 1e3) if xs else None


def _router_fields(router) -> dict:
    return {"per_engine_rows": [st.rows for st in router.stats()],
            "per_engine_occupancy": [st.occupancy
                                     for st in router.stats()],
            "per_engine_recompiles": router.per_engine_recompiles(),
            "engines_active": router.n_active,
            "serialized_dispatch_cpu": router.serialized_dispatch(),
            "caveat": _caveat(router)}


def run_soak(server: PolicyServer, pool: "list[tuple]", *,
             duration_s: float = 6.0, rate_hz: float = 200.0,
             deadline_s: "float | None" = None, router=None,
             advisor=None, advisor_every_s: float = 0.5) -> dict:
    """Sustained load through a RUNNING server (the caller started its
    dispatchers): submissions paced at ``rate_hz`` for ``duration_s``,
    each with the optional ``deadline_s`` (shedding on), and optionally
    the autoscale loop (every ``advisor_every_s``, ``advisor`` votes and
    ``router`` applies the vote live). Reports served and shed counts,
    the rate achieved, first-half against second-half p99 (an unbounded
    queue or a leak shows as second-half runaway), and with a router
    its per-engine rows, occupancy and recompiles."""
    if advisor is not None and router is None:
        raise ValueError("autoscale soak needs the router to apply "
                         "advisor votes to")
    interval = 1.0 / float(rate_hz)
    futures = []
    cursor = 0
    resizes = 0
    t_start = time.perf_counter()
    next_t = t_start
    next_tick = t_start + advisor_every_s
    while time.perf_counter() - t_start < duration_s:
        obs, mask = pool[cursor % len(pool)]
        futures.append(server.submit(obs, mask, deadline_s=deadline_s))
        cursor += 1
        if advisor is not None and time.perf_counter() >= next_tick:
            before = advisor.desired
            router.apply_autoscale(advisor)
            resizes += int(advisor.desired != before)
            next_tick += advisor_every_s
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
    half = len(lat_s) // 2
    p99_a, p99_b = _p99_ms(lat_s[:half]), _p99_ms(lat_s[half:])
    out = {
        "requests": len(futures),
        "served": len(futures) - shed,
        "shed": shed,
        "shed_rate": shed / max(len(futures), 1),
        "served_second_half": sum(x is not None for x in lat_s[half:]),
        "duration_s": wall,
        "rate_hz": rate_hz,
        "achieved_rate_hz": len(futures) / t_paced,
        "deadline_s": deadline_s,
        "p99_first_half_ms": p99_a,
        "p99_second_half_ms": p99_b,
        "p99_drift": (p99_b / p99_a
                      if p99_a and p99_b and p99_a > 0 else None),
        "autoscale_resizes": resizes if advisor is not None else None,
    }
    if router is not None:
        out.update(_router_fields(router))
    return out


def fit_paced_gaps(fit, n: int, seed, rate_hz: float) -> np.ndarray:
    """Inter-arrival gaps carrying a fitted workload's arrival SHAPE at a
    chosen offered rate: one seeded window from ``fit``
    (:func:`..traces.fit.gen_domain_window`, the arrival process the
    simulator replays), its inter-arrival gaps rescaled so the mean gap
    is exactly ``1/rate_hz``. The soak then carries the trace's bursts
    and idle stretches while the offered load stays the configured
    number. Deterministic per (fit, seed)."""
    from ..traces.fit import gen_domain_window

    if n < 1:
        raise ValueError(f"need at least one gap, got n={n}")
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be positive, got {rate_hz}")
    win = gen_domain_window(fit, n_jobs=n + 1, seed=seed, n_gpus=8,
                            load=1.0)
    gaps = np.maximum(np.diff(win.submit.astype(np.float64)), 0.0)
    mean = float(gaps.mean())
    if mean <= 0:       # a degenerate window (all burst): pace flat
        return np.full(n, 1.0 / rate_hz)
    return gaps * ((1.0 / rate_hz) / mean)


def _rss_bytes() -> "int | None":
    """This process's resident-set size from ``/proc/self/statm``, None
    where there is no procfs: the chaos soak's heap-drift numbers."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def run_chaos_soak(server: PolicyServer, pool: "list[tuple]", *, fit,
                   duration_s: float = 6.0, rate_hz: float = 150.0,
                   deadline_s: "float | None" = None, router=None,
                   seed: int = 0) -> dict:
    """:func:`run_soak` under chaos: arrivals paced by the fitted trace
    (:func:`fit_paced_gaps`) through a RUNNING dispatcher fleet while a
    :class:`.router.ServeFaultInjector` (attached to the router by the
    caller) fails engines mid-run. Every future is awaited with a bound
    and counted as exactly one of served, shed or failed, so the report
    carries the conservation invariant::

        submitted == served + shed + failed    (failed must be 0: the
        retry hedge absorbs injected engine faults)

    with the registry's shed count beside the observed one, and the
    router's ejection, readmission and hedge counts. The pacing loop
    runs the registry's collectors twice a second, so the SLO burn
    windows move during the faults; after the last future the soak
    keeps collecting until no SLO alerts (bounded), so ``slo`` shows the
    recovered budget."""
    n_gaps = max(int(duration_s * rate_hz * 2) + 16, 1)
    gaps = fit_paced_gaps(fit, n_gaps, seed=(seed, 0xC7A05),
                          rate_hz=rate_hz)
    reg = server.registry
    rss_start = _rss_bytes()
    futures = []
    cursor = 0
    t_start = time.perf_counter()
    next_t = t_start
    # a baseline sample before any fault: burn is measured between
    # samples, so a fault before the first collect would be invisible
    reg.collect()
    next_collect = t_start + 0.5
    while time.perf_counter() - t_start < duration_s:
        obs, mask = pool[cursor % len(pool)]
        futures.append(server.submit(obs, mask, deadline_s=deadline_s))
        next_t += gaps[cursor % len(gaps)]
        cursor += 1
        if time.perf_counter() >= next_collect:
            reg.collect()
            next_collect += 0.5
        sleep = next_t - time.perf_counter()
        if sleep > 0:
            time.sleep(sleep)
    lat_s: "list[float | None]" = []
    shed = 0
    failed = 0
    failure_kinds: dict[str, int] = {}
    for f in futures:
        try:
            lat_s.append(f.result(timeout=30).latency_s)
        except DeadlineSheddedError:
            shed += 1
            lat_s.append(None)
        except Exception as e:   # a failed dispatch, or a hung future
            failed += 1
            kind = type(e).__name__
            failure_kinds[kind] = failure_kinds.get(kind, 0) + 1
            lat_s.append(None)
    wall = time.perf_counter() - t_start
    served = len(futures) - shed - failed

    # settle: let the burn windows slide until no SLO alerts and the
    # short budget windows have recovered, bounded, so a still-burning
    # SLO reports alerting=True instead of hanging the soak
    slo_status: dict = {}
    if getattr(server, "slo", None) is not None:
        settle_by = time.perf_counter() + 4.0
        while True:
            reg.collect()
            slo_status = server.slo.status()
            settled = not any(s["alerting"] for s in slo_status.values())
            settled = settled and all(
                s["budget_remaining"] >= 1.0
                for s in slo_status.values()
                if s["alerts_total"] and s["budget_window_s"] <= 3.0)
            if settled or time.perf_counter() >= settle_by:
                break
            time.sleep(0.2)

    half = len(lat_s) // 2
    p99_a, p99_b = _p99_ms(lat_s[:half]), _p99_ms(lat_s[half:])
    out = {
        "requests": len(futures),
        "served": served,
        "shed": shed,
        "failed": failed,
        "failure_kinds": failure_kinds,
        "conservation_ok": len(futures) == served + shed + failed,
        "registry_requests_total": int(
            reg.counter("serve_requests_total").value),
        "registry_shed_total": int(reg.counter("serve_shed_total").value),
        "shed_rate": shed / max(len(futures), 1),
        "duration_s": wall,
        "rate_hz": rate_hz,
        "arrival_fit": fit.name,
        "deadline_s": deadline_s,
        "p99_first_half_ms": p99_a,
        "p99_second_half_ms": p99_b,
        "p99_drift": (p99_b / p99_a
                      if p99_a and p99_b and p99_a > 0 else None),
        "slo": slo_status,
    }
    # the heap-drift numbers: RSS before the first submit and after the
    # last future resolved (every recycled slab back in the ring)
    rss_end = _rss_bytes()
    out["rss_start_bytes"] = rss_start
    out["rss_end_bytes"] = rss_end
    out["rss_growth_bytes"] = (rss_end - rss_start
                               if rss_start is not None
                               and rss_end is not None else None)
    out["rss_growth_frac"] = ((rss_end - rss_start) / rss_start
                              if rss_start else None)
    if router is not None:
        out["fault_stats"] = router.fault_stats()
        fields = _router_fields(router)
        del fields["per_engine_occupancy"]
        out.update(fields)
    return out


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

    def decide(self, obs, mask, stall=None):
        n = int(np.asarray(leaves(obs)[0]).shape[0])
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


# the wire arms' concurrent client threads (enough to keep the batcher
# fed so dispatches coalesce), and their warm-up requests in all
WIRE_CLIENTS = 8
WIRE_WARMUP = 64


def _run_wire_arm(pool: "list[tuple]", *, bucket: int, framed: bool,
                  n_requests: int) -> dict:
    """One transport arm over a LIVE stack (a dispatcher thread, the
    asyncio front door and real sockets): one HTTP connection per
    request over the legacy plane, or one framed keep-alive connection
    per client over the arena. ``WIRE_CLIENTS`` concurrent client
    threads keep the batcher fed so dispatches coalesce. Clients and server
    share one interpreter, so the number is the whole host path, the
    wire parse included."""
    import socket
    import threading

    from . import wire
    from .frontend import start_frontend

    plane = "arena" if framed else "legacy"
    obs0, mask0 = pool[0]
    reg = Registry()
    engine = StubEngine(bucket)
    server = PolicyServer(engine, registry=reg, data_plane=plane,
                          example_obs=obs0, example_mask=mask0)
    server.start(dispatchers=1)
    handle = start_frontend(server, obs0, mask0, registry=reg)
    addr = ("127.0.0.1", handle.port)
    clients = WIRE_CLIENTS
    per_client = max(n_requests // clients, 1)
    warm_per_client = max(WIRE_WARMUP // clients, 1)
    ok = [0] * clients
    barrier = threading.Barrier(clients + 1)

    def http_request(obs, mask):
        body = (np.ascontiguousarray(obs).tobytes()
                + np.ascontiguousarray(mask).tobytes())
        return (f"POST /v1/decide HTTP/1.1\r\nHost: bench\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n\r\n").encode() + body

    def run_http(k: int) -> None:
        req = http_request(*pool[k % len(pool)])
        for phase, n in (("warm", warm_per_client),
                         ("measure", per_client)):
            if phase == "measure":
                barrier.wait()
            for _ in range(n):
                with socket.create_connection(addr) as s:
                    s.sendall(req)
                    buf = b""
                    while True:         # Connection: close -> read to EOF
                        c = s.recv(65536)
                        if not c:
                            break
                        buf += c
                if phase == "measure" and buf.startswith(b"HTTP/1.1 200"):
                    ok[k] += 1

    def run_framed(k: int) -> None:
        frame = wire.pack_request(*pool[k % len(pool)])
        with socket.create_connection(addr) as s:
            for phase, n in (("warm", warm_per_client),
                             ("measure", per_client)):
                if phase == "measure":
                    barrier.wait()
                for _ in range(n):
                    s.sendall(frame)
                    kind = wire.recv_frame(s)[0]
                    if phase == "measure" and kind == wire.KIND_RESP:
                        ok[k] += 1

    target = run_framed if framed else run_http
    threads = [threading.Thread(target=target, args=(k,), daemon=True)
               for k in range(clients)]
    try:
        for t in threads:
            t.start()
        barrier.wait(timeout=120)
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        occupancy = reg.gauge("serve_batch_occupancy").value
    finally:
        handle.close()
    served = sum(ok)
    return {
        "transport": ("framed keep-alive" if framed
                      else "http connection-per-request"),
        "data_plane": plane,
        "clients": clients,
        "requests": per_client * clients,
        "served": served,
        "conservation_ok": served == per_client * clients,
        "decisions_per_s": served / wall,
        "wall_s": wall,
        "last_batch_occupancy": float(occupancy),
        "post_warmup_recompiles": engine.post_warmup_recompiles,
    }


def run_host_path(pool: "list[tuple]", *,
                  max_bucket: int = 8, rounds: int = 300,
                  warmup_rounds: int = 12, wire_requests: int = 0) -> dict:
    """Host-path decisions/s of the two data planes: one in-process arm
    per plane (fresh registry, :class:`StubEngine` and server,
    inline-pumped so every dispatch is exactly ``max_bucket`` rows), the
    same request stream. The measured window wraps the numpy batch
    constructors (:class:`_AllocCounter`): the legacy arm's count is the
    per-batch churn, the arena arm's must be 0, and the arena's slab
    counter must stay flat.

    With ``wire_requests > 0`` two more arms measure the whole data
    plane through real sockets (:func:`_run_wire_arm`): one HTTP
    connection per request over the legacy plane against framed
    keep-alive connections over the arena, ``WIRE_CLIENTS`` client
    threads each. The headline ``speedup`` is then the wire arms' ratio, the
    in-process one kept as ``speedup_inproc``."""
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
    if wire_requests > 0:
        before = _run_wire_arm(pool, bucket=bucket, framed=False,
                               n_requests=wire_requests)
        after = _run_wire_arm(pool, bucket=bucket, framed=True,
                              n_requests=wire_requests)
        out["wire_arms"] = [before, after]
        base = before["decisions_per_s"]
        out["speedup"] = (after["decisions_per_s"] / base
                          if base > 0 else None)
    return out
