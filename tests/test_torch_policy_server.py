"""The port's continuous-batching policy server against the JAX
package's, and on its own.

- Parity: a ``PolicyServer`` over the port's engine and a JAX
  ``PolicyServer`` over the JAX engine get one request stream (sizes 5,
  7, 8, inline pump, both data planes): identical actions for every
  future, the same dispatches, padded slots, occupancies and buckets.
  The JAX engine's recompile count is not compared (under jax 0.9 its
  ``CompileCounter`` reads -1 and every dispatch counts as an alarm);
  the port's must be 0. Deadline shedding under one fake clock sheds
  the same requests for the same reasons, and the adaptive hold is the
  same number.
- The request pool equals JAX's on the same windows and weights:
  bitwise outside the tanh-squashed observation fields, within 3 f32
  ulp inside them (the env tests' rule).
- The server alone: FIFO scatter, ``max_wait``, the dispatcher thread,
  the arena against the legacy plane, zero steady-state allocations
  (over a stub engine and over the port's engine), rows refused at the
  door, request ids, ``close``.
"""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu.experiment import build_env_params as jbuild
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu.serve import bench as jbench
from rlgpuschedule_tpu.serve.batching import PolicyServer as JServer
from rlgpuschedule_tpu.serve.engine import InferenceEngine as JEngine
from rlgpuschedule_tpu.serve.fleet import fleet_windows as jfleet_windows
from rlgpuschedule_tpu_torch import configs as tconfigs
from rlgpuschedule_tpu_torch.decision import (policy_decision,
                                              preempt_slice,
                                              stall_threshold)
from rlgpuschedule_tpu_torch.experiment import build_env_params as tbuild
from rlgpuschedule_tpu_torch.experiment import build_policy
from rlgpuschedule_tpu_torch.models import make_policy, params_from_jax
from rlgpuschedule_tpu_torch.obs import Registry
from rlgpuschedule_tpu_torch.serve import (InferenceEngine, PolicyServer,
                                           ServerClosedError, StubEngine,
                                           build_request_pool, next_bucket,
                                           run_soak)
from rlgpuschedule_tpu_torch.serve.bench import _AllocCounter
from rlgpuschedule_tpu_torch.serve.router import EngineRouter
from rlgpuschedule_tpu_torch.serve.fleet import fleet_windows
from torch_jax_builds import jitted_env

torch.set_num_threads(1)

SMALL = dict(n_envs=2, window_jobs=12, horizon=96, n_nodes=4,
             gpus_per_node=4, queue_len=4)
SIZES = (5, 7, 8)
ULPS = 3


@pytest.fixture(scope="module")
def world():
    """Config 1 cut small: its JAX policy at f32, the port's twin with
    the converted weights, and 64 request rows drawn from a numpy seed
    (every mask keeps the no-op legal)."""
    jcfg = dataclasses.replace(jconfigs.CONFIGS["ppo-mlp-synth64"], **SMALL)
    tcfg = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"], **SMALL)
    jp, tp = jbuild(jcfg), tbuild(tcfg)
    net = jmake_policy("flat", jp.n_actions, dtype=jnp.float32)
    params = jax.device_get(jax.jit(net.init)(
        jax.random.PRNGKey(0), jnp.zeros((1,) + jp.obs_shape()),
        jnp.ones((1, jp.n_actions), bool)))
    policy = make_policy("flat", tp.n_actions, tp.obs_shape(),
                         dtype=torch.float32, device="cpu")
    policy.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(7)
    obs = rng.standard_normal((64,) + tp.obs_shape()).astype(np.float32)
    mask = rng.random((64, tp.n_actions)) < 0.6
    mask[:, -1] = True
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp,
                apply_fn=lambda p, o, m: net.apply(p, o, m),
                params=params, policy=policy, obs=obs, mask=mask)


def _engine(world, **kw):
    return InferenceEngine(world["policy"], max_bucket=8, device="cpu",
                           env_params=world["tp"], **kw)


def _drive(server, obs, mask, rounds=9):
    """Inline-pumped rounds of sizes 5, 7, 8; the futures in order."""
    futs, cursor = [], 0
    for r in range(rounds):
        k = SIZES[r % len(SIZES)]
        for _ in range(k):
            futs.append(server.submit(obs[cursor % len(obs)],
                                      mask[cursor % len(mask)]))
            cursor += 1
        assert server.pump() == k
    assert server.pump() == 0
    return futs


@pytest.mark.parametrize("plane", ["arena", "legacy"])
def test_server_matches_the_jax_server(world, plane):
    obs, mask = world["obs"], world["mask"]
    out = {}
    engines = {
        "jax": (JServer, JEngine(world["apply_fn"], world["params"],
                                 world["jp"], max_bucket=8, strict=False)),
        "port": (PolicyServer, _engine(world, strict=True))}
    for side, (server_cls, engine) in engines.items():
        server = server_cls(engine, data_plane=plane, example_obs=obs[0],
                            example_mask=mask[0])
        futs = _drive(server, obs, mask)
        snap = server.slo_snapshot()
        out[side] = dict(
            actions=[int(f.result(timeout=30).action) for f in futs],
            dispatches=snap["dispatches"], requests=snap["requests"],
            padded=server.registry.counter(
                "serve_padded_slots_total").value,
            occupancies=list(server._occupancies),
            occupancy_mean=snap["batch_occupancy_mean"],
            buckets=engine.warmed_buckets)
        server.close()
    assert out["port"] == out["jax"]
    assert out["port"]["dispatches"] == 9
    assert engines["port"][1].post_warmup_recompiles == 0
    assert engines["port"][1].warmed_buckets == (8,)
    # and the actions are the replay rule's on the same rows
    rows = np.arange(len(out["port"]["actions"])) % len(obs)
    with torch.no_grad():
        want = policy_decision(world["policy"], torch.from_numpy(obs[rows]),
                               torch.from_numpy(mask[rows]))
    assert out["port"]["actions"] == want.tolist()


class _ClockedArgmax:
    """Host engine for both packages' servers: per-row argmax over obs;
    each dispatch advances the fake clock by ``svc`` seconds."""

    def __init__(self, clock, svc=0.02, max_bucket=8):
        self.clock, self.svc, self.max_bucket = clock, svc, max_bucket
        self.post_warmup_recompiles = 0

    def bucket_for(self, n):
        return next_bucket(n, self.max_bucket)

    def decide(self, obs, mask, stall=None):
        self.clock.t += self.svc
        a = np.argmax(np.asarray(obs), axis=-1).astype(np.int32)
        return a, self.bucket_for(a.shape[0])


class _Clock:
    def __init__(self):
        self.t = 10.0

    def __call__(self):
        return self.t


def _shed_story(server_cls, plane, obs, mask):
    """One deadline story under a fake clock: expiry in the queue, then
    admission shedding once the service time is learned, then the
    adaptive hold. Returns every future's outcome and the counters."""
    clock = _Clock()
    server = server_cls(_ClockedArgmax(clock), clock=clock, data_plane=plane,
                        example_obs=obs[0], example_mask=mask[0],
                        adaptive_wait=True)
    futs = [server.submit(obs[i], mask[i], deadline_s=0.05 if i % 2 else None)
            for i in range(6)]
    clock.t += 0.1                            # the deadlined three expire
    served = [server.pump(max_wait_s=0)]
    # svc is learned (0.02 s): 8 requests fit one dispatch within a 0.03 s
    # deadline, the 9th and later would wait two dispatches
    futs += [server.submit(obs[i], mask[i], deadline_s=0.03)
             for i in range(12)]
    with server._lock:
        hold = server._effective_wait()
    served.append(server.pump(max_wait_s=0))
    futs += [server.submit(obs[i], mask[i], deadline_s=1.0)
             for i in range(3)]
    clock.t += 0.5
    with server._lock:
        hold2 = server._effective_wait()
    served.append(server.pump(max_wait_s=0))
    outcomes = []
    for f in futs:
        e = f.exception(timeout=10)
        if e is None:
            outcomes.append(("served", int(f.result(timeout=10).action)))
        else:
            # each package raises its own DeadlineSheddedError
            assert type(e).__name__ == "DeadlineSheddedError", e
            outcomes.append((e.reason, round(e.deadline_s, 6),
                             round(e.waited_s, 6),
                             None if e.predicted_wait_s is None
                             else round(e.predicted_wait_s, 6)))
    reg = server.registry
    counters = {k: reg.counter(k).value for k in
                ("serve_requests_total", "serve_shed_total",
                 "serve_dispatches_total", "serve_padded_slots_total")}
    server.close()
    return outcomes, counters, served, hold, hold2


@pytest.mark.parametrize("plane", ["arena", "legacy"])
def test_deadline_shedding_sheds_as_jax_sheds(world, plane):
    obs, mask = world["obs"], world["mask"]
    want = _shed_story(JServer, plane, obs, mask)
    got = _shed_story(PolicyServer, plane, obs, mask)
    assert got == want
    outcomes, counters, served, _, _ = got
    kinds = [o[0] for o in outcomes]
    assert kinds.count("expired") == 3 and kinds.count("admission") == 4
    assert served == [3, 8, 3]
    assert counters["serve_requests_total"] == (
        counters["serve_shed_total"] + sum(served))


def test_request_pool_matches_jax(world):
    jcfg, tcfg, jp, tp = world["jcfg"], world["tcfg"], world["jp"], world["tp"]
    _, jtraces = jfleet_windows(jcfg, 2)
    _, ttraces = fleet_windows(tcfg, 2, device="cpu")
    with jitted_env():      # JAX's helper resets and steps eagerly
        want = jbench.build_request_pool(world["apply_fn"], world["params"],
                                         jp, jtraces, steps=2)
    got = build_request_pool(world["policy"], tp, ttraces, steps=2)
    assert len(got) == len(want) == 6
    # flat rows: [N node fields][K x (demand, wait, service, valid)][2];
    # wait and service go through tanh
    q = np.zeros((tcfg.queue_len, 4), bool)
    q[:, 1:3] = True
    tanh = np.concatenate([np.zeros(tcfg.n_nodes, bool), q.ravel(),
                           np.zeros(2, bool)])
    for (to, tm), (jo, jm) in zip(got, want):
        jo, jm = np.asarray(jo), np.asarray(jm)
        assert to.dtype == jo.dtype and to.shape == jo.shape == tanh.shape
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(to[~tanh], jo[~tanh])
        ti = to[tanh].view(np.int32).astype(np.int64)
        ji = jo[tanh].view(np.int32).astype(np.int64)
        assert np.abs(ti - ji).max(initial=0) <= ULPS


def test_bench_report_keys_match_jax(world):
    from rlgpuschedule_tpu.serve.batching import PolicyServer as JS
    from rlgpuschedule_tpu_torch.serve import run_bench, run_host_path
    pool = [(world["obs"][i], world["mask"][i]) for i in range(16)]
    jeng = JEngine(world["apply_fn"], world["params"], world["jp"],
                   max_bucket=8)
    jrep = jbench.run_bench(jeng, JS(jeng), pool, rounds=3)
    teng = _engine(world)
    trep = run_bench(teng, PolicyServer(teng), pool, rounds=3)
    assert set(trep) == set(jrep) | {"graphs"}
    assert trep["post_warmup_recompiles"] == 0 and trep["graphs"] is False
    assert trep["requests"] == jrep["requests"] == 5 + 6 + 8
    jhp = jbench.run_host_path(pool, max_bucket=8, rounds=5)
    thp = run_host_path(pool, max_bucket=8, rounds=5)
    assert set(thp) == set(jhp)
    for ja, ta in zip(jhp["arms"], thp["arms"]):
        assert set(ta) == set(ja) and ta["data_plane"] == ja["data_plane"]
        assert ta["conservation_ok"] and ta["served"] == 40
    legacy, arena = thp["arms"]
    assert arena["alloc_calls"] == 0 and legacy["alloc_calls"] > 0
    assert arena["steady_state_slab_allocs"] == 0


def test_submit_pump_scatters_in_fifo_order(world):
    obs, mask = world["obs"], world["mask"]
    registry = Registry()
    engine = InferenceEngine(world["policy"], max_bucket=8, device="cpu",
                             registry=registry)
    server = PolicyServer(engine, registry=registry)
    futs = [server.submit(obs[i], mask[i]) for i in range(5)]
    assert server.pump() == 5
    want = engine.decide(obs[:5], mask[:5])[0]
    for i, f in enumerate(futs):
        res = f.result(timeout=10)
        assert int(res.action) == want[i]
        assert res.latency_s > 0 and res.req_id > 0
    assert server.pump() == 0
    snap = server.slo_snapshot()
    assert snap["requests"] == 5 and snap["dispatches"] == 1
    assert snap["n_chips"] == 1
    assert snap["batch_occupancy_mean"] == pytest.approx(5 / 8)
    rendered = registry.render()
    assert "serve_requests_total 5" in rendered
    assert "serve_decision_latency_p99_ms" in rendered
    assert "serve_bucket_compiles_total 1" in rendered
    server.close()


def test_pump_max_wait_dispatches_partial_after_deadline(world):
    obs, mask = world["obs"], world["mask"]
    engine = _engine(world)
    engine.warmup(obs[0], mask[0], buckets=(2, 8))
    server = PolicyServer(engine)
    futs = [server.submit(obs[i], mask[i]) for i in range(2)]
    t0 = time.perf_counter()
    assert server.pump(max_wait_s=0.2) == 2       # partial bucket, held
    assert time.perf_counter() - t0 >= 0.15
    assert all(f.result(timeout=10) for f in futs)
    futs = [server.submit(obs[i], mask[i]) for i in range(8)]
    t0 = time.perf_counter()
    assert server.pump(max_wait_s=30.0) == 8      # a full bucket never waits
    assert time.perf_counter() - t0 < 5.0
    assert all(f.result(timeout=10) for f in futs)
    assert engine.post_warmup_recompiles == 0


def test_pump_max_wait_cut_short_when_bucket_fills(world):
    obs, mask = world["obs"], world["mask"]
    engine = InferenceEngine(world["policy"], max_bucket=2, device="cpu")
    engine.warmup(obs[0], mask[0])
    server = PolicyServer(engine)
    server.submit(obs[0], mask[0])
    late = threading.Timer(0.1, server.submit, (obs[1], mask[1]))
    late.start()
    try:
        t0 = time.perf_counter()
        assert server.pump(max_wait_s=60.0) == 2
        assert time.perf_counter() - t0 < 30.0
    finally:
        late.cancel()
    assert server.pump() == 0


def test_max_wait_ctor_knob_validates_and_reaches_pump(world):
    engine = _engine(world)
    with pytest.raises(ValueError, match="max_wait_s"):
        PolicyServer(engine, max_wait_s=-1.0)
    server = PolicyServer(engine, max_wait_s=0.0)
    server.submit(world["obs"][0], world["mask"][0])
    assert server.pump() == 1


def test_background_dispatcher_serves_and_stops(world):
    obs, mask = world["obs"], world["mask"]
    engine = _engine(world, strict=True)
    engine.warmup(obs[0], mask[0])
    server = PolicyServer(engine)
    server.start()
    try:
        with pytest.raises(RuntimeError, match="already running"):
            server.start()
        futs = [server.submit(obs[i % 2], mask[i % 2]) for i in range(12)]
        assert len([f.result(timeout=30) for f in futs]) == 12
    finally:
        server.stop()
    assert not any(t.is_alive() for t in threading.enumerate()
                   if t.name == "serve-dispatcher-0")
    fut = server.submit(obs[0], mask[0])         # inline mode again
    assert server.pump() == 1
    assert fut.result(timeout=10) is not None
    assert engine.post_warmup_recompiles == 0


def test_soak_conserves_every_request(world):
    obs, mask = world["obs"], world["mask"]
    engine = _engine(world, strict=True)
    engine.warmup(obs[0], mask[0])
    registry = Registry()
    server = PolicyServer(engine, registry=registry, adaptive_wait=True)
    server.start()
    try:
        pool = [(obs[i], mask[i]) for i in range(16)]
        rep = run_soak(server, pool, duration_s=0.6, rate_hz=200.0,
                       deadline_s=0.05)
    finally:
        server.stop()
    assert rep["served"] + rep["shed"] == rep["requests"] > 60
    assert rep["p99_first_half_ms"] is not None
    assert registry.counter("serve_dispatch_errors_total").value == 0
    assert engine.post_warmup_recompiles == 0


class ArgmaxEngine:
    """Host engine: per-row argmax over obs, a FRESH array per dispatch
    (so the plane comparison is not view aliasing)."""

    def __init__(self, max_bucket=8):
        self.max_bucket = max_bucket
        self.post_warmup_recompiles = 0

    def bucket_for(self, n):
        return next_bucket(n, self.max_bucket)

    def decide(self, obs, mask, stall=None):
        a = np.argmax(np.asarray(obs), axis=-1).astype(np.int32)
        return a, self.bucket_for(a.shape[0])


class EchoEngine(ArgmaxEngine):
    """Returns a view of its own input's stall lane: the arena must copy
    it before the slab recycles."""

    def decide(self, obs, mask, stall=None):
        return stall, self.bucket_for(len(stall))


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(6).astype(np.float32),
             rng.integers(0, 2, 9).astype(bool) | True) for _ in range(n)]


def test_arena_and_legacy_planes_are_bit_identical():
    rows = _rows(40)
    actions = {}
    for plane in ("legacy", "arena"):
        server = PolicyServer(ArgmaxEngine(8), data_plane=plane,
                              example_obs=rows[0][0],
                              example_mask=rows[0][1])
        futs = [server.submit(o, m) for o, m in rows]
        while server.pump():
            pass
        actions[plane] = [int(f.result(timeout=10).action) for f in futs]
        server.close()
    assert actions["legacy"] == actions["arena"]


@pytest.mark.parametrize("engine_kind", ["stub", "port"])
def test_zero_steady_state_allocations(world, engine_kind):
    """After warmup, a full-bucket round on the arena plane calls none of
    the numpy batch constructors and allocates no slab, over the stub
    engine and over the port's engine; the legacy plane's count is not 0
    (the counter sees through)."""
    obs, mask = world["obs"], world["mask"]
    counts = {}
    for plane in ("legacy", "arena"):
        engine = StubEngine(8) if engine_kind == "stub" else _engine(world)
        server = PolicyServer(engine, data_plane=plane, example_obs=obs[0],
                              example_mask=mask[0])

        def one_round():
            for i in range(8):
                server.submit(obs[i], mask[i], stall=i)
            return server.pump()

        for _ in range(4):
            one_round()
        slabs = server.arena_stats()["slab_allocs"]
        with _AllocCounter() as counter:
            served = sum(one_round() for _ in range(16))
        counts[plane] = counter.calls
        assert served == 16 * 8
        assert server.arena_stats()["slab_allocs"] == slabs
        server.close()
    assert counts["arena"] == 0
    assert counts["legacy"] > 0


def test_scatter_copies_an_engine_buffer_that_aliases_the_slab():
    rows = _rows(8)
    server = PolicyServer(EchoEngine(8), data_plane="arena",
                          example_obs=rows[0][0], example_mask=rows[0][1])
    futs = [server.submit(o, m, stall=10 + i)
            for i, (o, m) in enumerate(rows)]
    assert server.pump() == 8
    futs2 = [server.submit(o, m, stall=0) for o, m in rows]   # reuses slabs
    while server.pump():
        pass
    assert [int(f.result(timeout=10).action) for f in futs] == list(range(10, 18))
    assert all(int(f.result(timeout=10).action) == 0 for f in futs2)
    server.close()


def test_submit_rejects_wrong_row_shape_at_the_door():
    rows = _rows(2)
    server = PolicyServer(ArgmaxEngine(8), data_plane="arena",
                          example_obs=rows[0][0], example_mask=rows[0][1])
    with pytest.raises(ValueError, match="obs row"):
        server.submit(np.zeros(7, np.float32), rows[0][1])
    with pytest.raises(ValueError, match="mask row"):
        server.submit(rows[0][0], np.ones(4, bool))
    fut = server.submit(*rows[1])               # the arena survives
    assert server.pump() == 1
    assert fut.result(timeout=10) is not None
    assert server.registry.counter("serve_requests_total").value == 3
    server.close()


def test_arena_stats_surface():
    rows = _rows(1)
    server = PolicyServer(ArgmaxEngine(8), data_plane="arena",
                          example_obs=rows[0][0], example_mask=rows[0][1])
    stats = server.arena_stats()
    assert stats["data_plane"] == "arena" and stats["blocks"] >= 1
    assert stats["rows"] == stats["blocks"] * 8
    # obs and mask slabs, stall and request-id lanes, per block
    assert stats["slab_allocs"] == stats["blocks"] * 4
    legacy = PolicyServer(ArgmaxEngine(8), data_plane="legacy")
    assert legacy.arena_stats()["blocks"] == 0
    legacy.close()
    server.close()


def test_request_ids_are_unique_salted_and_on_results():
    rows = _rows(8)
    server = PolicyServer(ArgmaxEngine(8), example_obs=rows[0][0],
                          example_mask=rows[0][1])
    futs = [server.submit(o, m) for o, m in rows[:7]]
    futs.append(server.submit(*rows[7], req_id=12345))
    assert server.pump() == 8
    ids = [f.result(timeout=10).req_id for f in futs]
    assert len(set(ids)) == 8 and ids[-1] == 12345
    assert len({i >> 40 for i in ids[:7]}) == 1      # one rank+pid salt
    assert all(0 < i < (1 << 63) for i in ids)
    server.close()


def test_close_refuses_later_submits_and_flushes_the_queue():
    rows = _rows(3)
    server = PolicyServer(ArgmaxEngine(8), example_obs=rows[0][0],
                          example_mask=rows[0][1])
    futs = [server.submit(o, m) for o, m in rows]
    server.close()                     # inline mode: close flushes
    assert all(f.done() and f.result(timeout=10).action is not None for f in futs)
    with pytest.raises(ServerClosedError):
        server.submit(*rows[0])
    with pytest.raises(ServerClosedError):
        server.start()
    assert server.closed
    server.close()                     # idempotent


def test_stall_gate_is_served_through_the_server():
    """A preemptive config's engine gets each request's stall count from
    the arena's stall lane: stalled requests are never served a preempt
    action, calm ones get the replay rule's."""
    cfg = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-preempt"], **SMALL)
    tp = tbuild(cfg)
    policy = build_policy(cfg, tp, dtype=torch.float32, device="cpu")
    engine = InferenceEngine(policy, max_bucket=8, device="cpu",
                             env_params=tp)
    rng = np.random.default_rng(3)
    obs = rng.standard_normal((8,) + tp.obs_shape()).astype(np.float32)
    mask = np.ones((8, tp.n_actions), bool)
    pre = preempt_slice(tp).numpy()
    thresh = stall_threshold(tp)
    server = PolicyServer(engine, example_obs=obs[0], example_mask=mask[0])
    stalled = [server.submit(obs[i], mask[i], stall=thresh) for i in range(8)]
    assert server.pump() == 8
    assert not pre[[int(f.result(timeout=10).action) for f in stalled]].any()
    calm = [server.submit(obs[i], mask[i]) for i in range(8)]
    assert server.pump() == 8
    with torch.no_grad():
        want = policy_decision(policy, torch.from_numpy(obs),
                               torch.from_numpy(mask))
    assert [int(f.result(timeout=10).action) for f in calm] == want.tolist()
    server.close()


def test_what_the_slice_lacks_is_refused(world):
    # a flight log needs a capture engine; a capture engine decides the
    # (actions, log_prob, value) triple
    with pytest.raises(ValueError, match="capture"):
        PolicyServer(ArgmaxEngine(8), flight_log=object())
    cap = _engine(world, capture=True)
    (acts, lp, val), b = cap.decide(world["obs"][:5], world["mask"][:5])
    assert cap.capture and b == 8 and acts.shape == lp.shape == val.shape
    np.testing.assert_array_equal(
        acts, _engine(world).decide(world["obs"][:5], world["mask"][:5])[0])
    # several dispatchers are the router's (tests/test_torch_router.py):
    # two of them over a 2-engine router serve every request
    router = EngineRouter(world["policy"], max_bucket=8, n_engines=2,
                          device="cpu")
    router.warmup(world["obs"][0], world["mask"][0])
    server = PolicyServer(router)
    with pytest.raises(ValueError, match="dispatchers"):
        server.start(dispatchers=0)
    server.start(dispatchers=2)
    try:
        futs = [server.submit(world["obs"][i], world["mask"][i])
                for i in range(24)]
        got = [int(f.result(timeout=30).action) for f in futs]
    finally:
        server.stop()
    with torch.no_grad():
        want = policy_decision(world["policy"],
                               torch.from_numpy(world["obs"][:24]),
                               torch.from_numpy(world["mask"][:24]))
    assert got == want.tolist()
    assert sum(s.rows for s in router.stats()) == 24
    server.close()


class _StretchedEngine:
    """Host engine under a fake clock: its first dispatch costs
    ``first_s`` (a dispatch stretched by a long garbage collection),
    every later one ``cost_s``."""

    def __init__(self, clock, first_s, cost_s, max_bucket=8):
        self.clock, self.max_bucket = clock, max_bucket
        self.costs = [first_s]
        self.cost_s = cost_s

    def bucket_for(self, n):
        return next_bucket(n, self.max_bucket)

    def decide(self, obs, mask, stall=None):
        self.clock.t += self.costs.pop() if self.costs else self.cost_s
        a = np.argmax(np.asarray(obs), axis=-1).astype(np.int32)
        return a, self.bucket_for(a.shape[0])


@pytest.mark.parametrize("plane", ["arena", "legacy"])
def test_admission_recovers_after_a_stretched_dispatch(plane):
    """The admission lockout, under a fake clock: one dispatch costs 5x
    the 50 ms deadline, every later one 1 ms, and deadlined requests
    arrive every 10 ms, each pumped inline. This fails on the server
    before the probe rule (and on JAX's, which keeps it): the estimate
    learned from the stretched dispatch sheds every later request at
    admission, no dispatch runs, and the estimate never falls. With
    the rule, a request that finds nothing queued or in flight and an
    estimate older than itself is admitted as a probe: it is the first
    request after one estimate (0.25 s) of sheds, its dispatch replaces
    the estimate with its own 1 ms, and every later request is
    served."""
    clock = _Clock()
    rows = _rows(8)
    server = PolicyServer(_StretchedEngine(clock, first_s=0.25,
                                           cost_s=0.001),
                          clock=clock, data_plane=plane,
                          example_obs=rows[0][0], example_mask=rows[0][1])
    first = server.submit(*rows[0])
    assert server.pump() == 1 and first.result(timeout=10).latency_s == 0.25
    assert server._service_time.value == 0.25       # 5x the deadline
    outcomes = []
    for k in range(200):
        clock.t += 0.01
        fut = server.submit(*rows[k % 8], deadline_s=0.05)
        server.pump(max_wait_s=0)
        outcomes.append(fut.exception(timeout=10) is None)
        if outcomes[-1] and outcomes.count(True) == 1:
            # the probe's dispatch relearned the estimate in one step
            assert server._service_time.value == pytest.approx(0.001)
    probe = outcomes.index(True) if True in outcomes else None
    assert probe is not None, "no dispatch ran after the stall"
    assert probe <= 25 and all(outcomes[probe:])
    shed = server.registry.counter("serve_shed_total").value
    assert shed == outcomes.count(False) == probe
    server.close()


class _PausedEngine(_StretchedEngine):
    """Host engine under a fake clock: 1 ms dispatches, except dispatch
    ``k`` (0-based), which costs ``pause_s`` (a full collection holding
    every thread)."""

    def __init__(self, clock, k, pause_s, max_bucket=8):
        super().__init__(clock, first_s=0.001, cost_s=0.001,
                         max_bucket=max_bucket)
        self.costs = [0.001] * (k + 1)
        self.costs[0] = pause_s


@pytest.mark.parametrize("plane", ["arena", "legacy"])
def test_one_paused_dispatch_does_not_shed_the_burst_behind_it(plane):
    """After 10 dispatches of 1 ms, one takes 0.6 s (a pause), and then
    the 40 requests the pause held back arrive at once with 50 ms
    deadlines: 5 dispatches of 8 ahead of the last. Taken whole, the
    pause would lift the estimate to 0.12 s and shed the whole burst at
    admission (the probe rule cannot help: the queue is not empty). The
    sample is capped at ``SAMPLE_CAP`` times the estimate, so the
    estimate stays near 1.6 ms, the burst is admitted and served, and a
    lasting slowdown would still be learned."""
    from rlgpuschedule_tpu_torch.serve.batching import SAMPLE_CAP
    clock = _Clock()
    rows = _rows(8)
    server = PolicyServer(_PausedEngine(clock, k=10, pause_s=0.6),
                          clock=clock, data_plane=plane,
                          example_obs=rows[0][0], example_mask=rows[0][1])
    for k in range(11):
        fut = server.submit(*rows[k % 8], deadline_s=0.05)
        assert server.pump(max_wait_s=0) == 1
        fut.result(timeout=10)
        clock.t += 0.01
    assert server._service_time.value == pytest.approx(
        0.2 * SAMPLE_CAP * 0.001 + 0.8 * 0.001)
    burst = [server.submit(*rows[k % 8], deadline_s=0.05)
             for k in range(40)]
    while server.pump(max_wait_s=0):
        pass
    assert all(f.exception(timeout=10) is None for f in burst)
    assert server.registry.counter("serve_shed_total").value == 0
    server.close()
