"""The port's multi-engine router, fault injector and autoscale advisor
against the JAX package's, and on their own (CPU only).

The cases are JAX's own (``tests/test_router.py``), built on the same
fixtures: a row-wise linear policy (``linear_apply``, here a port-side
``nn.Module`` holding the same seeded weights), a host ``FakeEngine``
advancing a fake clock, and ``fake_server``. The routed actions are held
to a single port engine, to the JAX package's single
``InferenceEngine`` and to the row-wise reference; the router is held to
its dispatch accounting, never to recompile counts (JAX's read -1 under
its installed version). Every wait is bounded.

The deadline cases cannot reach the admission stall: their streams learn
the service time from one dispatch and shed right after it, where the
port sheds as JAX does (``tests/test_torch_policy_server.py`` holds the
stall and its probe).
"""
import threading
import time

import numpy as np
import pytest
import torch
from torch import nn

from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu.obs import Registry as JRegistry
from rlgpuschedule_tpu.serve.engine import InferenceEngine as JEngine
from rlgpuschedule_tpu_torch import configs as tconfigs
from rlgpuschedule_tpu_torch.analysis import sentinels
from rlgpuschedule_tpu_torch.device import serve_devices
from rlgpuschedule_tpu_torch.obs import Registry
from rlgpuschedule_tpu_torch.serve import (AutoscaleAdvisor,
                                           DeadlineSheddedError,
                                           EngineRouter, InferenceEngine,
                                           InjectedEngineFault, PolicyServer,
                                           ServeFaultInjector,
                                           ServeFaultSpec, ServeResult,
                                           ServerClosedError, next_bucket,
                                           parse_serve_fault, run_chaos_soak,
                                           run_scaleout)
from rlgpuschedule_tpu_torch.traces.fit import domain_fit

torch.set_num_threads(1)

OBS_D, ACT_D = 6, 9


def linear_apply(params, obs, mask):
    """JAX's row-wise linear policy head."""
    return obs @ params["w"], None


class LinearPolicy(nn.Module):
    """The port's twin of ``linear_apply``: row-wise, so per-request
    actions do not depend on how the router coalesced them."""

    def __init__(self, w: np.ndarray):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(w.copy()),
                              requires_grad=False)

    def forward(self, obs, mask):
        return obs @ self.w, None


def make_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((OBS_D, ACT_D)).astype(np.float32)}


def make_batch(rng, n):
    obs = rng.standard_normal((n, OBS_D)).astype(np.float32)
    mask = rng.integers(0, 2, (n, ACT_D)).astype(bool)
    mask[:, 0] = True           # at least one legal action per row
    return obs, mask


def make_router(n_engines=2, max_bucket=8, registry=None, **kw):
    return EngineRouter(LinearPolicy(make_params()["w"]),
                        max_bucket=max_bucket, registry=registry,
                        n_engines=n_engines, device="cpu", **kw)


def single_engine(max_bucket=8):
    return InferenceEngine(LinearPolicy(make_params()["w"]),
                           max_bucket=max_bucket, device="cpu")


class FakeEngine:
    """Host engine: every dispatch advances the shared fake clock by
    ``cost_s``, so the server's service-time estimate is exact."""

    def __init__(self, clock_cell, max_bucket=8, cost_s=0.05):
        self.max_bucket = max_bucket
        self.cost_s = cost_s
        self.dispatches = 0
        self._t = clock_cell

    def bucket_for(self, n):
        return next_bucket(n, self.max_bucket)

    def decide(self, obs, mask, stall=None):
        n = int(np.asarray(obs).shape[0])
        self._t[0] += self.cost_s
        self.dispatches += 1
        return np.asarray(obs), self.bucket_for(n)


def fake_server(max_bucket=8, cost_s=0.05, **kw):
    t = [0.0]
    reg = Registry()
    server = PolicyServer(FakeEngine(t, max_bucket, cost_s), registry=reg,
                          clock=lambda: t[0], **kw)
    return server, t, reg


def row(rng):
    return (rng.standard_normal(OBS_D).astype(np.float32),
            np.ones(ACT_D, bool))


# ---- routed actions --------------------------------------------------------

class TestRoutedActions:
    def test_fleet_matches_one_engine_and_the_jax_engine(self):
        """Per batch, the routed actions equal one port engine's and the
        JAX package's single ``InferenceEngine``'s on the same rows,
        both engines serve, and no engine raises a recompile alarm."""
        params = make_params()
        router = make_router()
        single = single_engine()
        jsingle = JEngine(linear_apply, params, max_bucket=8,
                          registry=JRegistry(), stall_gate=False)
        rng = np.random.default_rng(0)
        batches = [make_batch(rng, int(rng.integers(1, 9)))
                   for _ in range(12)]
        obs0, mask0 = batches[0]
        for e in (router, single, jsingle):
            e.warmup(obs0[0], mask0[0])
        for obs, mask in batches:
            a_r, b_r = router.decide(obs, mask)
            a_s, b_s = single.decide(obs, mask)
            a_j, b_j = jsingle.decide(obs, mask)
            assert b_r == b_s == b_j
            np.testing.assert_array_equal(a_r, a_s)
            np.testing.assert_array_equal(a_r, np.asarray(a_j))
        assert router.per_engine_recompiles() == [0, 0]
        rows = [s.rows for s in router.stats()]
        assert all(r > 0 for r in rows), rows
        assert sum(rows) == sum(o.shape[0] for o, _ in batches)

    def test_threaded_fleet_matches_rowwise_reference(self):
        """Through the PolicyServer with 2 live dispatchers: whatever
        batches the router coalesced, every request's action is the
        argmax of its own row's logits."""
        reg = Registry()
        router = make_router(registry=reg)
        rng = np.random.default_rng(1)
        rows = [row(rng) for _ in range(60)]
        router.warmup(*rows[0])
        server = PolicyServer(router, registry=reg)
        server.start(dispatchers=2)
        try:
            futs = [server.submit(o, m) for o, m in rows]
            got = [int(f.result(timeout=60).action) for f in futs]
        finally:
            server.stop()
        w = make_params()["w"]
        want = [int(np.argmax(o @ w)) for o, _ in rows]
        assert got == want
        assert router.per_engine_recompiles() == [0, 0]
        assert sum(s.rows for s in router.stats()) == 60
        server.close()

    def test_per_engine_labeled_series_in_scrape(self):
        reg = Registry()
        router = make_router(registry=reg)
        rng = np.random.default_rng(2)
        obs, mask = make_batch(rng, 4)
        router.warmup(obs[0], mask[0], buckets=(4,))
        router.decide(obs, mask)
        router.decide(obs, mask)
        text = reg.render()
        for i in (0, 1):
            assert f'serve_engine_rows_total{{engine="{i}"}}' in text
            assert f'serve_recompile_alarms_total{{engine="{i}"}}' in text
        assert "serve_engines_total 2" in text
        assert "serve_engines_active 2" in text

    def test_engines_own_their_policy_copies(self):
        """Each engine serves its own copy of the weights; a swap reaches
        every engine, drained ones included, and changes the actions."""
        router = make_router(max_bucket=4)
        rng = np.random.default_rng(3)
        obs, mask = make_batch(rng, 4)
        router.warmup(obs[0], mask[0], buckets=(4,))
        p0, p1 = (e.policy.w for e in router.engines)
        assert p0.data_ptr() != p1.data_ptr()
        before, _ = router.decide(obs, mask)
        router.set_active(1)
        new = {"w": torch.from_numpy(make_params(7)["w"])}
        fired = []
        router.add_rewarm_listener(lambda: fired.append(1))
        assert router.swap_params(new) == (4,)
        for e in router.engines:
            torch.testing.assert_close(e.policy.w, new["w"], rtol=0, atol=0)
        after, _ = router.decide(obs, mask)
        np.testing.assert_array_equal(
            after, np.argmax(obs @ make_params(7)["w"], -1))
        assert not np.array_equal(before, after) and fired == [1]
        assert router.per_engine_recompiles() == [0, 0]


# ---- least-loaded dispatch and the live resize -------------------------------

class TestLeastLoaded:
    def test_equal_batches_split_evenly(self):
        router = make_router(max_bucket=4)
        rng = np.random.default_rng(3)
        obs, mask = make_batch(rng, 4)
        router.warmup(obs[0], mask[0], buckets=(4,))
        for _ in range(6):
            router.decide(obs, mask)
        stats = router.stats()
        assert [s.dispatches for s in stats] == [3, 3]
        assert [s.rows for s in stats] == [12, 12]
        assert [s.occupancy for s in stats] == [1.0, 1.0]

    def test_fewest_rows_breaks_ties(self):
        """Sequential dispatches (inflight always 0 at pick time) route
        by lifetime rows: after a big batch lands on engine 0, the
        smaller ones pile onto engine 1 until it catches up."""
        router = make_router(max_bucket=8)
        rng = np.random.default_rng(4)
        o8, m8 = make_batch(rng, 8)
        o1, m1 = make_batch(rng, 1)
        router.warmup(o8[0], m8[0], buckets=(1, 8))
        router.decide(o8, m8)           # engine 0: 8 rows
        for _ in range(8):
            router.decide(o1, m1)       # all catch-up goes to engine 1
        stats = router.stats()
        assert stats[0].rows == 8
        assert stats[1].rows == 8

    def test_inflight_preferred_over_rows(self):
        router = make_router()
        assert router._acquire() == 0
        assert router._acquire() == 1   # engine 0 is busy
        router._release(0, 0, None)     # aborted dispatch: no rows booked
        assert router._acquire() == 0   # free again, beats busy engine 1
        router._release(0, 0, None)
        router._release(1, 0, None)
        assert all(s.inflight == 0 for s in router.stats())

    def test_set_active_drains_and_reactivates(self):
        router = make_router(max_bucket=4)
        rng = np.random.default_rng(5)
        obs, mask = make_batch(rng, 4)
        router.warmup(obs[0], mask[0], buckets=(4,))
        assert router.set_active(1) == 1
        for _ in range(4):
            router.decide(obs, mask)
        stats = router.stats()
        assert stats[0].dispatches == 4 and stats[1].dispatches == 0
        assert not stats[1].active
        assert router.set_active(2) == 2
        router.decide(obs, mask)        # least-loaded: engine 1 next
        assert router.stats()[1].dispatches == 1
        assert router.per_engine_recompiles() == [0, 0]

    def test_spinup_warms_cold_engine_before_traffic(self):
        router = make_router(max_bucket=4)
        rng = np.random.default_rng(6)
        obs, mask = make_batch(rng, 4)
        router.set_active(1)
        router.warmup(obs[0], mask[0])          # engine 1 inactive: cold
        assert router.engines[1].warmed_buckets == ()
        router.set_active(2)
        assert router.engines[1].warmed_buckets == (1, 2, 4)
        for _ in range(4):
            router.decide(obs, mask)
        assert router.per_engine_recompiles() == [0, 0]
        assert router.stats()[1].rows > 0

    def test_spinup_waits_for_inflight_dispatches(self):
        """A spin-up holds the router quiet: it warms the cold engine
        only after the dispatch in flight finishes, and a dispatch that
        arrives meanwhile waits for the warm to end."""
        router = make_router(max_bucket=4)
        rng = np.random.default_rng(16)
        obs, mask = make_batch(rng, 4)
        router.set_active(1)
        router.warmup(obs[0], mask[0])
        order = []
        cold = router.engines[1]
        warm = cold.warmup

        def traced_warm(*a, **k):
            order.append("warm")
            return warm(*a, **k)

        cold.warmup = traced_warm
        inside, release = threading.Event(), threading.Event()

        def in_flight():
            with router._device_work():
                inside.set()
                assert release.wait(10)
                order.append("dispatch done")

        t = threading.Thread(target=in_flight)
        t.start()
        assert inside.wait(10)
        spin = threading.Thread(target=router.set_active, args=(2,))
        spin.start()
        time.sleep(0.1)
        assert order == []          # the spin-up waits for the dispatch
        release.set()
        t.join(10)
        spin.join(10)
        assert not t.is_alive() and not spin.is_alive()
        assert order == ["dispatch done", "warm"]
        assert cold.warmed_buckets == (1, 2, 4)
        router.decide(obs, mask)
        assert router.per_engine_recompiles() == [0, 0]

    def test_set_active_clamps(self):
        router = make_router()
        assert router.set_active(0) == 1        # never below one engine
        assert router.set_active(99) == 2       # never above the fleet

    def test_set_active_fires_rewarm_listeners_on_change_only(self):
        router = make_router(max_bucket=4)
        fired = []
        router.add_rewarm_listener(lambda: fired.append(1))
        assert router.set_active(2) == 2        # already 2: no change
        assert fired == []
        assert router.set_active(1) == 1
        assert len(fired) == 1
        assert router.set_active(1) == 1        # steady: still silent
        assert len(fired) == 1
        rng = np.random.default_rng(7)
        obs, mask = make_batch(rng, 4)
        router.warmup(obs[0], mask[0])          # engine 1 inactive: cold
        router.set_active(2)                    # spin-up warm => fires
        assert len(fired) == 2

    def test_policy_server_resets_estimator_on_router_rewarm(self):
        router = make_router(max_bucket=4)
        rng = np.random.default_rng(8)
        obs, mask = make_batch(rng, 4)
        router.warmup(obs[0], mask[0])
        server = PolicyServer(router, example_obs=obs[0],
                              example_mask=mask[0])
        for i in range(4):
            server.submit(obs[i], mask[i])
        assert server.pump() == 4
        assert server.service_time_s() is not None
        router.set_active(1)                    # fleet changed
        assert server.service_time_s() is None  # estimator reset
        server.close()

    def test_n_engines_and_devices(self):
        with pytest.raises(ValueError, match="n_engines"):
            make_router(n_engines=0)
        # engines beyond the devices share them (JAX refuses instead)
        assert serve_devices(3, "cpu") == [torch.device("cpu")] * 3
        assert make_router(n_engines=3).devices == (torch.device("cpu"),)
        assert serve_devices(None, "cpu") == [torch.device("cpu")]

    def test_serialized_dispatch_on_the_cpu(self):
        assert make_router().serialized_dispatch() is True

    def test_router_hier_combination_refused_in_jax_words(self):
        with pytest.raises(tconfigs.ModeCombinationError) as got:
            tconfigs.validate_mode_combination({"router": True,
                                                "hier": True})
        with pytest.raises(jconfigs.ModeCombinationError) as want:
            jconfigs.validate_mode_combination({"router": True,
                                                "hier": True})
        assert str(got.value) == str(want.value)
        tconfigs.validate_mode_combination({"router": True, "hier": False})
        tconfigs.validate_mode_combination({"router": False, "hier": True})


# ---- deadline shedding (JAX's cases) -----------------------------------------

class TestDeadlineShedding:
    def test_expired_request_resolves_with_typed_rejection(self):
        server, t, reg = fake_server()
        rng = np.random.default_rng(7)
        fut = server.submit(*row(rng), deadline_s=0.5)
        t[0] += 1.0
        assert server.pump() == 0       # nothing left to serve
        with pytest.raises(DeadlineSheddedError) as ei:
            fut.result(timeout=10)
        assert ei.value.reason == "expired"
        assert ei.value.waited_s == pytest.approx(1.0)
        assert reg.counter("serve_shed_total").value == 1

    def test_admission_shed_uses_learned_service_time(self):
        """JAX's fresh-estimate case: at an empty queue right after a
        0.05 s dispatch, a 0.01 s deadline is shed at the door (the
        probe rule admits only once the estimate is older than
        itself)."""
        server, t, reg = fake_server(cost_s=0.05)
        rng = np.random.default_rng(8)
        ok = server.submit(*row(rng))
        server.pump()                   # learns service time = 0.05
        assert isinstance(ok.result(timeout=10), ServeResult)
        fut = server.submit(*row(rng), deadline_s=0.01)
        assert fut.done()               # rejected at the door, no queue
        with pytest.raises(DeadlineSheddedError) as ei:
            fut.result(timeout=10)
        assert ei.value.reason == "admission"
        assert ei.value.predicted_wait_s == pytest.approx(0.05)
        assert reg.counter("serve_shed_total").value == 1
        assert server.pump() == 0       # the shed request never queued

    def test_cold_server_admits_rather_than_guessing(self):
        server, t, _ = fake_server()
        rng = np.random.default_rng(9)
        fut = server.submit(*row(rng), deadline_s=1e-9)
        assert not fut.done()           # no service estimate yet: admit
        assert server.pump() == 1
        assert isinstance(fut.result(timeout=10), ServeResult)

    def test_mid_queue_expiry_not_masked_by_generous_head(self):
        server, t, reg = fake_server()
        rng = np.random.default_rng(10)
        head = server.submit(*row(rng))
        tail = server.submit(*row(rng), deadline_s=0.1)
        t[0] += 0.2
        assert server.pump() == 1
        assert isinstance(head.result(timeout=10), ServeResult)
        with pytest.raises(DeadlineSheddedError):
            tail.result(timeout=10)
        assert reg.counter("serve_shed_total").value == 1

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_no_request_is_ever_silently_dropped(self, seed):
        server, t, reg = fake_server(max_bucket=4, cost_s=0.02)
        rng = np.random.default_rng(seed)
        futs = []
        for _ in range(40):
            deadline = (None if rng.random() < 0.4
                        else float(rng.uniform(0.005, 0.2)))
            futs.append(server.submit(*row(rng), deadline_s=deadline))
            t[0] += float(rng.uniform(0.0, 0.05))
            if rng.random() < 0.3:
                server.pump()
        while server._pending:
            server.pump()
        shed = 0
        for f in futs:
            assert f.done(), "a submitted request's future never resolved"
            try:
                assert isinstance(f.result(timeout=10), ServeResult)
            except DeadlineSheddedError:
                shed += 1
        assert reg.counter("serve_shed_total").value == shed


# ---- the autoscale advisor ----------------------------------------------------

def advisor_reg(p99=10.0, depth=0, occ=0.6, shed=0):
    """Registry primed with a healthy steady-state SLO surface; override
    one signal per test."""
    reg = Registry()
    reg.gauge("serve_decision_latency_p99_ms").set(p99)
    reg.gauge("serve_queue_depth").set(depth)
    reg.gauge("serve_batch_occupancy").set(occ)
    if shed:
        reg.counter("serve_shed_total").inc(shed)
    return reg


class TestAutoscaleHysteresis:
    def test_steady_load_never_flaps(self):
        reg = advisor_reg()
        adv = AutoscaleAdvisor(reg, n_max=4, initial=2, hysteresis=3)
        for _ in range(20):
            assert adv.observe() == 2
        assert reg.counter("serve_autoscale_resizes_total").value == 0
        assert reg.gauge("serve_autoscale_desired_engines").value == 2

    def test_scale_up_needs_consecutive_votes(self):
        reg = advisor_reg(depth=100)
        adv = AutoscaleAdvisor(reg, n_max=4, initial=2, hysteresis=3,
                               queue_high=64)
        assert adv.observe() == 2
        assert adv.observe() == 2
        assert adv.observe() == 3       # third consecutive up vote lands
        assert reg.counter("serve_autoscale_resizes_total").value == 1

    def test_mixed_votes_reset_the_streak(self):
        reg = advisor_reg(depth=100)
        adv = AutoscaleAdvisor(reg, n_max=4, initial=2, hysteresis=3)
        adv.observe()
        adv.observe()                                   # two up votes
        reg.gauge("serve_queue_depth").set(0)           # healthy: hold
        assert adv.observe() == 2                       # streak reset
        reg.gauge("serve_queue_depth").set(100)
        adv.observe()
        adv.observe()
        assert adv.desired == 2                         # needs a fresh 3
        assert adv.observe() == 3

    def test_scale_down_on_idle_clamps_at_n_min(self):
        reg = advisor_reg(p99=5.0, occ=0.1)
        adv = AutoscaleAdvisor(reg, n_max=4, initial=2, hysteresis=2)
        adv.observe()
        assert adv.observe() == 1
        for _ in range(6):
            assert adv.observe() == 1   # clamped, no further resizes
        assert reg.counter("serve_autoscale_resizes_total").value == 1

    def test_shedding_is_an_up_vote(self):
        reg = advisor_reg()
        adv = AutoscaleAdvisor(reg, n_max=4, initial=2, hysteresis=1)
        assert adv.observe() == 2                       # no shed delta
        reg.counter("serve_shed_total").inc(3)
        assert adv.observe() == 3                       # delta observed
        assert adv.observe() == 3                       # delta consumed

    def test_p99_over_target_is_an_up_vote(self):
        reg = advisor_reg(p99=80.0)
        adv = AutoscaleAdvisor(reg, n_max=4, initial=2, hysteresis=1,
                               p99_target_ms=50.0)
        assert adv.observe() == 3

    def test_unset_gauges_never_scale_up(self):
        adv = AutoscaleAdvisor(Registry(), n_max=4, initial=2,
                               hysteresis=1)
        for _ in range(5):
            assert adv.observe() <= 2

    def test_router_applies_votes_live(self):
        reg = advisor_reg(p99=5.0, occ=0.1)
        router = make_router(max_bucket=4, registry=reg)
        rng = np.random.default_rng(15)
        obs, mask = make_batch(rng, 4)
        router.warmup(obs[0], mask[0], buckets=(4,))
        adv = AutoscaleAdvisor(reg, n_max=2, initial=2, hysteresis=1)
        assert router.apply_autoscale(adv) == 1         # idle: drain
        reg.gauge("serve_queue_depth").set(100)
        assert router.apply_autoscale(adv) == 2         # pressure: grow
        router.decide(obs, mask)
        assert router.per_engine_recompiles() == [0, 0]

    def test_validation(self):
        with pytest.raises(ValueError, match="n_min"):
            AutoscaleAdvisor(Registry(), n_max=0)
        with pytest.raises(ValueError, match="hysteresis"):
            AutoscaleAdvisor(Registry(), n_max=2, hysteresis=0)


# ---- faults and engine health ---------------------------------------------

class _Bus:
    """Event-bus stand-in recording (kind, fields) tuples."""

    def __init__(self):
        self.events = []

    def emit(self, kind, **fields):
        self.events.append((kind, fields))

    def kinds(self):
        return [k for k, _ in self.events]


def health_router(specs, injector_kw=None, bus=None, **kw):
    """2-engine router with a fake monotonic clock and an armed fault
    injector, for deterministic ejection and back-off tests."""
    now = [100.0]
    inj = ServeFaultInjector(specs, bus=bus, **(injector_kw or {}))
    router = make_router(registry=Registry(), fault_injector=inj, bus=bus,
                         probe_backoff_s=0.5, clock=lambda: now[0], **kw)
    return router, now


class TestServeFaultSpecs:
    def test_parse_round_trip(self):
        s = parse_serve_fault("engine-hang@10:engine=1")
        assert (s.kind, s.at, s.engine, s.fired) == \
            ("engine-hang", 10, 1, False)
        assert parse_serve_fault(" engine-raise@3 ").engine == 0

    @pytest.mark.parametrize("bad", [
        "engine-raise", "nope@3", "engine-raise@x",
        "engine-raise@3:rank=1", "engine-raise@3:engine=x"])
    def test_parse_rejects_with_the_offending_spec(self, bad):
        with pytest.raises(ValueError, match="serve-fault") as got:
            parse_serve_fault(bad)
        assert repr(bad) in str(got.value)

    def test_ge_semantics_fire_exactly_once(self):
        inj = ServeFaultInjector([ServeFaultSpec("engine-raise", at=2,
                                                 engine=1)])
        inj.on_dispatch(1, 0)                   # below at: no-op
        inj.on_dispatch(0, 5)                   # wrong engine: no-op
        with pytest.raises(InjectedEngineFault):
            inj.on_dispatch(1, 5)               # >= at: fires
        inj.on_dispatch(1, 6)                   # spent: no-op
        assert inj.specs[0].fired

    def test_slow_returns_hang_raises(self):
        inj = ServeFaultInjector(
            [ServeFaultSpec("engine-slow", at=0),
             ServeFaultSpec("engine-hang", at=1)],
            slow_s=0.0, hang_s=0.0)
        inj.on_dispatch(0, 0)                   # brownout: succeeds
        with pytest.raises(InjectedEngineFault, match="hung"):
            inj.on_dispatch(0, 1)


class TestEngineHealth:
    def test_consecutive_failures_eject_then_backoff_readmits(self):
        router, now = health_router(
            [ServeFaultSpec("engine-raise", at=0),
             ServeFaultSpec("engine-raise", at=0)])
        rng = np.random.default_rng(20)
        obs, mask = make_batch(rng, 4)
        router.warmup(obs[0], mask[0])
        router.decide(obs, mask)        # fail 1 on engine 0 -> hedge
        router.decide(obs, mask)        # fail 2 -> EJECT -> hedge
        assert router.fault_stats() == {
            "failures": 2, "ejections": 1, "readmissions": 0,
            "retry_hedges": 2, "engines_ejected": 1}
        st = router.stats()
        assert st[0].ejected and not st[1].ejected
        assert st[0].consecutive_failures == 2
        router.decide(obs, mask)        # back-off not elapsed: no probe
        assert router.stats()[0].dispatches == 0
        now[0] += 1.0                   # past the 0.5 s back-off
        router.decide(obs, mask)        # probe passes -> readmitted
        fs = router.fault_stats()
        assert fs["readmissions"] == 1 and fs["engines_ejected"] == 0
        st = router.stats()
        assert not st[0].ejected and st[0].consecutive_failures == 0
        assert st[0].dispatches >= 1
        assert router.per_engine_recompiles() == [0, 0]

    def test_single_transient_failure_never_ejects(self):
        router, _ = health_router([ServeFaultSpec("engine-raise", at=0)])
        rng = np.random.default_rng(21)
        obs, mask = make_batch(rng, 2)
        router.warmup(obs[0], mask[0])
        a, b = router.decide(obs, mask)         # hedged transparently
        assert np.asarray(a).shape[0] == 2 and b == 2
        router.decide(obs, mask)                # success resets streak
        fs = router.fault_stats()
        assert fs["failures"] == 1 and fs["ejections"] == 0
        assert all(s.consecutive_failures == 0 for s in router.stats())

    def test_slow_engine_is_not_ejected(self):
        router, _ = health_router([ServeFaultSpec("engine-slow", at=0)],
                                  injector_kw={"slow_s": 0.0})
        rng = np.random.default_rng(22)
        obs, mask = make_batch(rng, 2)
        router.warmup(obs[0], mask[0])
        router.decide(obs, mask)
        fs = router.fault_stats()
        assert fs["failures"] == 0 and fs["retry_hedges"] == 0

    def test_failed_probe_doubles_backoff_until_fault_clears(self):
        router, now = health_router(
            [ServeFaultSpec("engine-raise", at=0),
             ServeFaultSpec("engine-raise", at=0),
             ServeFaultSpec("engine-raise", at=0)])
        rng = np.random.default_rng(23)
        obs, mask = make_batch(rng, 4)
        router.warmup(obs[0], mask[0])
        router.decide(obs, mask)        # fail 1
        router.decide(obs, mask)        # fail 2 -> eject, probe at +0.5
        now[0] += 0.6
        router.decide(obs, mask)        # probe fires spec 3 -> FAILS
        fs = router.fault_stats()
        assert fs["failures"] == 3 and fs["readmissions"] == 0
        assert router.stats()[0].ejected
        now[0] += 0.5                   # inside the DOUBLED (1 s) back-off
        router.decide(obs, mask)
        assert router.fault_stats()["readmissions"] == 0
        now[0] += 1.0                   # past it; fault set exhausted
        router.decide(obs, mask)
        fs = router.fault_stats()
        assert fs["readmissions"] == 1 and fs["engines_ejected"] == 0

    def test_total_engine_loss_raises_then_recovers(self):
        router, now = health_router(
            [ServeFaultSpec("engine-raise", at=0, engine=0),
             ServeFaultSpec("engine-raise", at=0, engine=1)],
            eject_after=1)
        rng = np.random.default_rng(24)
        obs, mask = make_batch(rng, 2)
        router.warmup(obs[0], mask[0])
        with pytest.raises(InjectedEngineFault):
            router.decide(obs, mask)    # both engines eject, loudly
        fs = router.fault_stats()
        assert fs["engines_ejected"] == 2 and fs["retry_hedges"] == 1
        with pytest.raises(RuntimeError, match="no active healthy"):
            router.decide(obs, mask)    # nothing to serve with
        now[0] += 1.0                   # probes pass (faults spent)
        a, b = router.decide(obs, mask)
        assert b == 2
        np.testing.assert_array_equal(
            a, np.argmax(obs @ make_params()["w"], -1))
        assert router.fault_stats()["readmissions"] == 2

    def test_lifecycle_lands_on_the_event_bus(self):
        bus = _Bus()
        router, now = health_router(
            [ServeFaultSpec("engine-raise", at=0),
             ServeFaultSpec("engine-raise", at=0)], bus=bus)
        rng = np.random.default_rng(25)
        obs, mask = make_batch(rng, 2)
        router.warmup(obs[0], mask[0])
        router.decide(obs, mask)
        router.decide(obs, mask)
        now[0] += 1.0
        router.decide(obs, mask)
        kinds = bus.kinds()
        for want in ("serve_fault", "serve_retry", "engine_eject",
                     "engine_readmit"):
            assert want in kinds, kinds
        eject = dict(bus.events)["engine_eject"]
        assert eject["engine"] == 0
        assert eject["consecutive_failures"] == 2
        assert eject["error"] == "InjectedEngineFault"

    def test_hedged_batch_equals_a_healthy_fleet(self):
        """The retry hedge must not change answers: a faulted fleet's
        output equals a healthy single engine's and the JAX engine's
        for the same rows."""
        router, _ = health_router([ServeFaultSpec("engine-raise", at=0)])
        single = single_engine()
        jsingle = JEngine(linear_apply, make_params(), max_bucket=8,
                          registry=JRegistry(), stall_gate=False)
        rng = np.random.default_rng(26)
        obs, mask = make_batch(rng, 4)
        router.warmup(obs[0], mask[0], buckets=(4,))
        single.warmup(obs[0], mask[0], buckets=(4,))
        a_r, b_r = router.decide(obs, mask)     # served via the hedge
        a_s, b_s = single.decide(obs, mask)
        a_j, _ = jsingle.decide(obs, mask)
        assert b_r == b_s and router.fault_stats()["retry_hedges"] == 1
        np.testing.assert_array_equal(a_r, a_s)
        np.testing.assert_array_equal(a_r, np.asarray(a_j))


# ---- the server over several dispatchers -----------------------------------

class TestServerClosedAndShedAccounting:
    def test_close_refuses_submit_and_start_forever(self):
        server, t, reg = fake_server()
        rng = np.random.default_rng(30)
        fut = server.submit(*row(rng))
        server.close()
        assert isinstance(fut.result(timeout=10), ServeResult)
        with pytest.raises(ServerClosedError, match="closed"):
            server.submit(*row(rng))
        with pytest.raises(ServerClosedError):
            server.start(dispatchers=2)
        server.close()                          # idempotent

    def test_multi_dispatcher_shed_counted_exactly_once(self):
        """4 dispatcher threads race the same expiry scans and admission
        path under real time: submitted == served + shed, and the
        counter equals the typed rejections observed."""
        class SleepyEngine:
            max_bucket = 1

            def bucket_for(self, n):
                return next_bucket(n, 1)

            def decide(self, obs, mask, stall=None):
                time.sleep(0.002)
                return np.asarray(obs), 1

        reg = Registry()
        server = PolicyServer(SleepyEngine(), registry=reg)
        rng = np.random.default_rng(35)
        o, m = row(rng)
        server.start(dispatchers=4)
        assert server.arena_stats()["blocks"] == 0      # sized lazily
        try:
            futs = [server.submit(o, m, deadline_s=0.004)
                    for _ in range(120)]
        finally:
            server.stop()
        assert server.arena_stats()["blocks"] >= 6      # dispatchers + 2
        served = shed = 0
        for f in futs:
            try:
                assert isinstance(f.result(timeout=30), ServeResult)
                served += 1
            except DeadlineSheddedError:
                shed += 1
        assert served + shed == len(futs) == 120
        assert reg.counter("serve_shed_total").value == shed
        assert reg.counter("serve_requests_total").value == 120
        assert shed > 0, "the race was never exercised"
        server.close()

    def test_start_grows_the_ring_for_its_dispatchers(self):
        """At bucket 256 the ring starts at its floor of 4 blocks;
        ``start(dispatchers=3)`` grows it to 3 + 2, and a later start
        with fewer dispatchers keeps the blocks it has."""
        server = PolicyServer(FakeEngine([0.0], max_bucket=256),
                              example_obs=np.zeros(OBS_D, np.float32),
                              example_mask=np.ones(ACT_D, bool))
        assert server.arena_stats()["blocks"] == 4
        server.start(dispatchers=3)
        server.stop()
        assert server.arena_stats()["blocks"] == 5
        server.start(dispatchers=1)
        server.stop()
        assert server.arena_stats()["blocks"] == 5
        server.close()


# ---- the scale-out and chaos benches --------------------------------------

def _pool(n=32, seed=40):
    rng = np.random.default_rng(seed)
    return [row(rng) for _ in range(n)]


def test_run_scaleout_accounts_every_row():
    rep = run_scaleout(LinearPolicy(make_params()["w"]), None, _pool(),
                       max_bucket=8, rounds=6, request_sizes=(5, 8),
                       engine_counts=(1, 2), device="cpu")
    assert rep["engine_counts"] == [1, 2]
    assert rep["serialized_dispatch_cpu"] is True
    assert "serializes" in rep["caveat"]
    for arm in rep["arms"]:
        assert arm["requests"] == arm["served"] == 3 * 5 + 3 * 8
        assert sum(arm["per_engine_rows"]) == arm["served"]
        assert len(arm["per_engine_rows"]) == arm["engines"]
        assert arm["per_engine_recompiles"] == [0] * arm["engines"]
        assert sum(arm["per_engine_dispatches"]) == arm["dispatches"]
        assert sum(arm["per_engine_row_share"]) == pytest.approx(1.0)


def test_router_behind_the_arena_counts_live_rows():
    """A departure from JAX: its arena dispatches the padded bucket, so
    its router books padding as served rows (occupancy 1.0 always); the
    port's arena hands the engine its live rows, and the router's rows,
    slots and occupancy are the real ones."""
    router = make_router()
    pool = _pool(8)
    router.warmup(*pool[0])
    server = PolicyServer(router)
    futs = [server.submit(o, m) for o, m in pool[:5]]
    assert server.pump() == 5
    assert [f.result(timeout=10).action.shape for f in futs] == [()] * 5
    st = router.stats()[0]
    assert (st.rows, st.slots, st.occupancy) == (5, 8, 5 / 8)
    server.close()


def test_run_chaos_soak_conserves_every_request():
    """engine-raise, engine-hang and engine-slow on engine 1 of a
    2-engine fleet: every request is served or shed (failed == 0), the
    registry's shed count equals the observed one, and the injected
    faults show in the router's health numbers."""
    reg = Registry()
    specs = [parse_serve_fault(s) for s in
             ("engine-raise@2:engine=1", "engine-hang@6:engine=1",
              "engine-slow@10:engine=1")]
    inj = ServeFaultInjector(specs, hang_s=0.05, slow_s=0.02)
    router = make_router(registry=reg, fault_injector=inj)
    pool = _pool()
    router.warmup(*pool[0])
    server = PolicyServer(router, registry=reg)
    server.start(dispatchers=2)
    try:
        rep = run_chaos_soak(server, pool,
                             fit=domain_fit(tconfigs.CONFIGS[
                                 "ppo-mlp-synth64"]),
                             duration_s=0.6, rate_hz=150.0,
                             deadline_s=None, router=router, seed=0)
    finally:
        server.stop()
    assert rep["conservation_ok"] and rep["failed"] == 0
    assert rep["requests"] == rep["served"] + rep["shed"]
    assert rep["registry_shed_total"] == rep["shed"]
    assert rep["registry_requests_total"] == rep["requests"] > 20
    assert all(s.fired for s in specs)
    fs = rep["fault_stats"]
    assert fs["failures"] == 2 and fs["retry_hedges"] == 2
    assert rep["per_engine_recompiles"] == [0, 0]
    assert rep["arrival_fit"] == "synthetic"
    server.close()


# ---- the sync guard across threads -----------------------------------------

def test_sync_guard_restores_only_when_the_last_thread_leaves(monkeypatch):
    """Two threads inside ``no_implicit_transfers`` at once: the first in
    sets the mode, the first out restores nothing, the last out puts
    back the mode the first one found (the mode is process-wide)."""
    mode = {"v": 0}
    sets = []

    def set_mode(m):
        mode["v"] = {"error": 2}.get(m, m)
        sets.append(mode["v"])

    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: mode["v"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    a_in, b_in, a_out, b_go = (threading.Event() for _ in range(4))
    seen = {}

    def a():
        with sentinels.no_implicit_transfers("cuda"):
            a_in.set()
            assert b_in.wait(10)
        seen["after_a"] = mode["v"]
        a_out.set()

    def b():
        assert a_in.wait(10)
        with sentinels.no_implicit_transfers("cuda"):
            b_in.set()
            assert b_go.wait(10)
            seen["inside_b"] = mode["v"]
        seen["after_b"] = mode["v"]

    ta, tb = threading.Thread(target=a), threading.Thread(target=b)
    ta.start()
    tb.start()
    assert a_out.wait(10)
    b_go.set()
    ta.join(10)
    tb.join(10)
    assert not ta.is_alive() and not tb.is_alive()
    assert seen == {"after_a": 2, "inside_b": 2, "after_b": 0}
    assert sets == [2, 0]
