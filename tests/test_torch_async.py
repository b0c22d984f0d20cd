"""The port's async actor-learner engine against the JAX package's, on
the CPU, at ``tests/test_async.py``'s small size (2 x 4 GPUs, 4 envs x 8
steps, 1 epoch x 2 minibatches).

Parity with JAX where JAX is deterministic:

- ``parse_group_spec`` and ``split_devices`` on the ids of the
  conftest's 8 virtual CPU devices: the same choices and the same
  refusals (by type and text);
- ``TrajectoryQueue``, ``_ParamSlot`` and ``OverlapMeter`` under one
  scripted fake clock and thread schedule: the same waits, orders,
  errors and snapshots;
- ``AsyncGauges``: the same ``metrics.prom`` names, help strings and
  values;
- one JAX ``AsyncRunner`` run (shared single-device group, a resample
  and checkpoint cadence, telemetry) against the port's: the same
  barrier set, checkpoint meta, ``run_start``/``run_end`` keys and
  values that do not time anything, and ``async_info()`` keys; the
  population's exploit prediction against JAX's ``PBTController`` fed
  the same window.

The port's own contracts (exact unless a tolerance is named):

- bound 0 is ``Experiment.run`` bit for bit (params, optimizer, both
  generators, carry, window cursor, iteration) across resample and
  checkpoint barriers, and the population's bound 0 is the sync
  population's across 2 exploit rounds (params, hyperparameters,
  generators, decisions);
- V-trace at bound 0 holds params within atol 1e-5 of the uncorrected
  sync loop and every logged ``rho`` within 1e-6 of 1 (the batched
  recompute is not row-equal to the rollout's per-step forwards, so
  not bits: ROADMAP.md queue 3);
- bound 1 keeps ``staleness_max <= 1``; bound 4 with V-trace runs deep
  (``staleness_max > 1``) with finite losses; a negative bound and a
  capacity below 1 are refused; a barrier checkpoint restored into a
  fresh build continues bit for bit; no program is built after warmup;
  bound 1's mean reward over the last 4 of 8 iterations lies within
  0.05 of the sync loop's;
- the telemetry surface, the actor's sync guard (``Alarms.watch``) and
  the nesting of ``intended_sync``.
"""
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu import async_engine as jeng
from rlgpuschedule_tpu.configs import PPO_MLP_SYNTH64 as J_SYNTH64
from rlgpuschedule_tpu.obs import RunTelemetry as JRunTelemetry
from rlgpuschedule_tpu.obs import merge_dir as jmerge_dir
from rlgpuschedule_tpu.obs import telemetry as jtel
from rlgpuschedule_tpu.obs.metrics import Registry as JRegistry
from rlgpuschedule_tpu.parallel import groups as jgroups
from rlgpuschedule_tpu.parallel import pbt as jpbt
from rlgpuschedule_tpu_torch import async_engine as teng
from rlgpuschedule_tpu_torch.analysis import sentinels
from rlgpuschedule_tpu_torch.analysis.sentinels import CompileCounter
from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
from rlgpuschedule_tpu_torch.configs import PPO_MLP_SYNTH64
from rlgpuschedule_tpu_torch.experiment import (Experiment,
                                                PopulationExperiment)
from rlgpuschedule_tpu_torch.obs import RunTelemetry, merge_dir
from rlgpuschedule_tpu_torch.obs import telemetry as ttel
from rlgpuschedule_tpu_torch.obs.events import EventBus
from rlgpuschedule_tpu_torch.obs.metrics import Registry
from rlgpuschedule_tpu_torch.parallel import PBTConfig
from rlgpuschedule_tpu_torch.parallel import groups as tgroups
from rlgpuschedule_tpu_torch.tree import leaves
from torch_jax_builds import _JIT_CARRY, fast_jax_build

BASE = dict(name="async-test", n_envs=4, n_nodes=2, gpus_per_node=4,
            window_jobs=16, horizon=64, queue_len=4, resample_every=0)


def small_cfg(ppo_kw=None, **kw):
    """``tests/test_async.py``'s ``small_cfg`` in the port."""
    ppo = dataclasses.replace(PPO_MLP_SYNTH64.ppo, **{
        "n_steps": 8, "n_epochs": 1, "n_minibatches": 2, **(ppo_kw or {})})
    return dataclasses.replace(PPO_MLP_SYNTH64, **{**BASE, **kw}, ppo=ppo)


def build(cfg):
    return Experiment.build(cfg, device="cpu")


def run_state(exp) -> dict:
    """What a run carries: parameters, optimizer state, carry tensors,
    both generators' states and the host counters."""
    return {"params": exp.net.state_dict(),
            "opt": exp.train_state.opt.state_dict()["state"],
            "carry": (exp.carry.env_state, exp.carry.obs, exp.carry.mask),
            "gens": (exp.carry.generator.get_state(),
                     exp.generator.get_state()),
            "host": (exp.window_cursor, exp.iteration)}


def assert_same_run(a, b):
    sa, sb = run_state(a), run_state(b)
    assert sa["host"] == sb["host"]
    for k in ("params", "opt", "carry", "gens"):
        xs = [x for x in leaves(sa[k]) if isinstance(x, torch.Tensor)]
        ys = [y for y in leaves(sb[k]) if isinstance(y, torch.Tensor)]
        assert len(xs) == len(ys) > 0, k
        assert all(torch.equal(x, y) for x, y in zip(xs, ys)), k


# ---- device groups ---------------------------------------------------------

GROUP_SPECS = [
    {}, {"actor": 2, "learner": 3}, {"actor": "0,1", "learner": "1,0"},
    {"actor": "0,1", "learner": "1,2"}, {"actor": "0,99"},
    {"actor": "1,1"}, {"actor": 3}, {"learner": 2}, {"actor": 9},
    {"actor": "two"}, {"learner": "0,a"}, {"actor": " 2 "},
    {"actor": "7", "learner": "7"}]


@pytest.mark.parametrize("spec", GROUP_SPECS, ids=str)
def test_split_devices_chooses_and_refuses_as_jax(spec):
    def outcome(split, devices, ident):
        try:
            g = split(devices=devices, **spec)
        except ValueError as e:
            return "ValueError", str(e)
        return ([ident(d) for d in g.actor], [ident(d) for d in g.learner],
                g.shared, g.describe())

    jdev = jax.devices()
    tdev = [torch.device("cuda", d.id) for d in jdev]
    assert outcome(jgroups.split_devices, jdev, lambda d: d.id) == outcome(
        tgroups.split_devices, tdev, tgroups.device_id)
    if not spec:                     # one device: a shared group
        assert outcome(jgroups.split_devices, jdev[:1], lambda d: d.id) \
            == outcome(tgroups.split_devices, tdev[:1], tgroups.device_id)


@pytest.mark.parametrize("spec", [None, 3, " 2 ", "0,2,3", "two", "0,a"])
def test_parse_group_spec_is_jaxs(spec):
    def outcome(parse):
        try:
            return parse(spec)
        except ValueError as e:
            return str(e)

    assert outcome(jgroups.parse_group_spec) == outcome(
        tgroups.parse_group_spec)


def test_wider_groups_and_the_mesh_wait_for_item_21():
    cpu = tgroups.split_devices(devices="cpu")
    assert cpu.shared and cpu.describe() == "shared group: 1 device(s) [0]"
    cpu.check_runnable()
    wide = tgroups.split_devices(
        devices=[torch.device("cuda", i) for i in range(4)])
    assert wide.describe() == "actor [0, 1] | learner [2, 3]"
    with pytest.raises(NotImplementedError, match=r"item 21\)"):
        wide.check_runnable()
    with pytest.raises(NotImplementedError, match=r"item 21\)"):
        tgroups.split_mesh(None)
    exp = build(small_cfg())
    with pytest.raises(ValueError, match="learner group"):
        teng.AsyncRunner(exp, groups=tgroups.split_devices(
            devices=[torch.device("cuda", 0)]))


# ---- the host protocol under a scripted clock --------------------------------

def ticks(step=1.0, jump_after=None):
    """A fake clock: each read advances ``step``; after ``jump_after``
    reads it jumps 1,000 s (a stall)."""
    n = [0]

    def clock():
        n[0] += 1
        t = n[0] * step
        return t + 1000.0 if jump_after and n[0] > jump_after else t

    return clock


def queue_script(mod) -> list:
    """One schedule of puts, gets, a blocked get a peer thread releases,
    a stall and an abort; what each step returned or raised."""
    out = []
    q = mod.TrajectoryQueue(2, clock=ticks(), stall_timeout_s=5.0)
    for i in range(2):
        out.append(("put", q.put(mod._QueueItem(index=i, version=i,
                                                batch=f"b{i}"))))
    out.append(("len", len(q)))
    for _ in range(2):
        item, waited = q.get()
        out.append(("get", item.index, item.batch, waited))
    got = {}

    def consumer():
        got["item"], got["waited"] = q.get()

    t = threading.Thread(target=consumer)
    t.start()
    time.sleep(0.05)                 # the consumer is waiting on the queue
    q.put(mod._QueueItem(index=7, version=6, batch="late"))
    t.join(10)
    out.append(("released", got["item"].index, got["waited"]))
    stalled = mod.TrajectoryQueue(1, clock=ticks(jump_after=2),
                                  stall_timeout_s=5.0)
    stalled.put(mod._QueueItem(index=0, version=0, batch=None))
    try:
        stalled.put(mod._QueueItem(index=1, version=0, batch=None))
    except RuntimeError as e:
        out.append(("stall", str(e)))
    q.abort(RuntimeError("peer died"))
    try:
        q.get()
    except mod._Aborted as e:
        out.append(("aborted", type(e).__name__, str(e.__cause__)))
    try:
        mod.TrajectoryQueue(0)
    except ValueError as e:
        out.append(("capacity", str(e)))
    return out


def slot_script(mod) -> list:
    out = []
    slot = mod._ParamSlot("v0", version=0, clock=ticks(),
                          stall_timeout_s=5.0)
    out.append(("ready", slot.wait_for(0)))
    got = {}

    def actor():
        got["r"] = slot.wait_for(2)

    t = threading.Thread(target=actor)
    t.start()
    time.sleep(0.05)
    slot.publish("v1", 1)            # not enough: the gate holds
    time.sleep(0.05)
    slot.publish("v2", 2)
    t.join(10)
    out.append(("gated", got["r"], slot.version))
    stalled = mod._ParamSlot("p", 0, clock=ticks(jump_after=1),
                             stall_timeout_s=5.0)
    try:
        stalled.wait_for(3)
    except RuntimeError as e:
        out.append(("stall", str(e)))
    slot.abort()
    try:
        slot.wait_for(9)
    except mod._Aborted as e:
        out.append(("aborted", type(e).__name__))
    return out


def overlap_script(meter_cls) -> dict:
    clock = iter([0.0, 4.0, 8.0, 10.0, 11.0, 12.0, 13.0, 20.0, 21.0,
                  30.0]).__next__
    m = meter_cls(clock=clock)
    with m.span("actor"):            # [0, 10]
        with m.span("learner"):      # [4, 8]: 4 s together
            pass
    with m.span("learner"):          # [11, 12] alone
        pass
    with m.span("actor"):            # [13, 30] around the learner's
        with m.span("learner"):      # [20, 21]: 1 s together
            pass
    return {**m.snapshot(), "busy": dict(m.busy_s)}


def test_queue_slot_and_meter_follow_jax_under_one_script():
    assert queue_script(teng) == queue_script(jeng)
    assert slot_script(teng) == slot_script(jeng)
    got = overlap_script(ttel.OverlapMeter)
    assert got == overlap_script(jtel.OverlapMeter)
    assert got["overlap_s"] == 5.0


def test_async_gauges_render_as_jax():
    regs = []
    for reg_cls, gauges in ((Registry, ttel.AsyncGauges),
                            (JRegistry, jtel.AsyncGauges)):
        reg = reg_cls()
        gauges(reg).publish(queue_depth=2, staleness=1,
                            actor_idle_s=0.1234567, learner_idle_s=2.5,
                            overlap_s=1.0000004,
                            importance_ratio_mean=0.9876543,
                            importance_ratio_max=1.25)
        regs.append(reg.render())
    assert regs[0] == regs[1]
    assert "# HELP rlsched_async_param_staleness policy-versions behind" \
        in regs[0]


# ---- one JAX run against the port's -----------------------------------------

CADENCE = dict(iterations=3, log_every=1, ckpt_every=2)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX ``AsyncRunner`` run on a shared single-device group at the
    small size, with a resample and a checkpoint cadence (the checkpoint
    recorded, not written: JAX's is orbax) and its telemetry."""
    cfg = dataclasses.replace(
        J_SYNTH64, **{**BASE, "resample_every": 2},
        ppo=dataclasses.replace(J_SYNTH64.ppo, n_steps=8, n_epochs=1,
                                n_minibatches=2))
    exp = fast_jax_build(cfg)
    saved = []
    exp.save_checkpoint = lambda ckpt, meta=None: saved.append(meta)
    d = str(tmp_path_factory.mktemp("jax_async"))
    with pytest.MonkeyPatch.context() as mp:
        # the resample's carry reset, jitted (the module's shared program)
        mp.setattr(jeng, "init_carry",
                   lambda p, t, k, f=None: _JIT_CARRY(p, t, k, f))
        r = jeng.AsyncRunner(exp, groups=jgroups.split_devices(
            devices=jax.devices()[:1]), staleness_bound=0)
        with JRunTelemetry(d, trace=True) as tel:
            out = r.run(ckpt=object(), telemetry=tel, **CADENCE)
    return {"barriers": list(r._barriers), "saved": saved, "out": out,
            "events": jmerge_dir(d), "info": r.async_info()}


def _event(events, kind):
    return next(e for e in events if e["kind"] == kind)


def test_one_run_has_jaxs_barriers_meta_and_telemetry(jax_run, tmp_path):
    exp = build(small_cfg(resample_every=2))
    r = teng.AsyncRunner(exp, staleness_bound=0)
    with Checkpointer(str(tmp_path / "ck")) as ck, \
            RunTelemetry(str(tmp_path / "obs"), trace=True,
                         device="cpu") as tel:
        out = r.run(ckpt=ck, telemetry=tel, **CADENCE)
        metas = [ck.read_meta(s) for s in ck.all_steps()]
    assert r._barriers == jax_run["barriers"] == [1, 2]
    assert [{k: m[k] for k in ("async_iteration", "staleness_bound")}
            for m in metas] == [
        {k: m[k] for k in ("async_iteration", "staleness_bound")}
        for m in jax_run["saved"]]
    ev, jev = merge_dir(str(tmp_path / "obs")), jax_run["events"]
    for kind in ("run_start", "run_end"):
        mine, theirs = _event(ev, kind), _event(jev, kind)
        assert set(mine) == set(theirs), kind
    start = _event(ev, "run_start")
    jstart = _event(jev, "run_start")
    for k in ("loop", "iterations", "n_envs", "steps_per_iteration",
              "staleness_bound", "queue_capacity", "actor_devices",
              "learner_devices", "shared_group", "config", "algo"):
        assert start[k] == jstart[k], k
    assert start["loop"] == "async-experiment"
    assert set(out["async"]) == set(jax_run["info"])
    assert set(out) == set(jax_run["out"])
    spans = {e["span"] for e in ev if e["kind"] == "span_begin"}
    jspans = {e["span"] for e in jev if e["kind"] == "span_begin"}
    assert spans == jspans
    assert set(out["phase_seconds"]) == set(jax_run["out"]["phase_seconds"])


@pytest.mark.parametrize("carried,ready", [(0, 2), (1, 2), (2, 3)])
def test_population_exploit_prediction_is_jaxs_controller(carried, ready,
                                                          jax_run,
                                                          monkeypatch):
    """The runner's exploit barriers are where JAX's ``PBTController``,
    fed the same carried-in window, fires."""
    iters, n_pop = 4, 2
    jctrl = jpbt.PBTController(n_pop, jpbt.PBTConfig(ready_iters=ready))
    monkeypatch.setattr(jpbt, "gather_members", lambda s, src: s)
    fired = []
    for k in range(-carried, iters):
        jctrl.record(np.ones(n_pop, np.float32))
        out = jctrl.maybe_update(k, None, jpbt.HParams(
            *[np.ones(n_pop, np.float32)] * 3))
        if out is not None and k >= 0:
            fired.append(k)
    pexp = PopulationExperiment.build(
        small_cfg(ppo_kw={"n_steps": 4}), n_pop=n_pop, device="cpu",
        pbt_cfg=PBTConfig(ready_iters=ready, seed=0))
    for _ in range(carried % ready):
        pexp.controller.record(torch.ones(n_pop))
    r = teng.AsyncPopulationRunner(pexp, staleness_bound=0)
    out = r.run(iters)
    assert r._barriers == fired
    assert out["pbt_events"] == len(fired)
    # JAX's population info: its runner's keys and the member vectors
    assert list(r.async_info()) == [
        *list(jax_run["info"])[:-2], "staleness_last_per_member",
        "staleness_max_per_member", *list(jax_run["info"])[-2:]]


# ---- the port's contracts --------------------------------------------------

def test_bound0_is_the_sync_loop_bit_for_bit_across_barriers(tmp_path):
    cfg = small_cfg(resample_every=3)
    ref = build(cfg)
    with Checkpointer(str(tmp_path / "a")) as ck:
        ref.run(7, ckpt=ck, ckpt_every=2, log_every=3)
    exp = build(cfg)
    with Checkpointer(str(tmp_path / "b")) as ck:
        out = exp.run_async(7, staleness_bound=0, ckpt=ck, ckpt_every=2,
                            log_every=3)
        steps = ck.all_steps()
    assert_same_run(ref, exp)
    assert out["async"]["staleness_max"] == 0 and out["window_cursor"] == 8
    assert [h["iteration"] for h in out["history"]] == [0, 3, 6]
    with Checkpointer(str(tmp_path / "a")) as ck:
        assert ck.all_steps() == steps


def test_resume_from_a_barrier_checkpoint_continues_bit_for_bit(tmp_path):
    cfg = small_cfg(resample_every=2)
    ref = build(cfg)
    ref.run_async(6, staleness_bound=0)
    a = build(cfg)
    with Checkpointer(str(tmp_path / "ck")) as ck:
        a.run_async(3, staleness_bound=0, ckpt=ck, ckpt_every=3)
    b = build(cfg)
    with Checkpointer(str(tmp_path / "ck")) as ck:
        meta = b.restore_checkpoint(ck)
    assert meta["async_iteration"] == 2 and meta["staleness_bound"] == 0
    b.run_async(3, staleness_bound=0)
    assert_same_run(ref, b)


def test_population_bound0_is_the_sync_population(tmp_path):
    cfg = small_cfg(ppo_kw={"n_steps": 4})

    def pop():
        return PopulationExperiment.build(
            cfg, n_pop=2, device="cpu",
            pbt_cfg=PBTConfig(ready_iters=2, seed=cfg.seed))

    a, b = pop(), pop()
    a.run(4, log_every=1)
    out = b.run_async(4, staleness_bound=0, log_every=1)
    assert len(a.controller.history) == out["pbt_events"] == 2
    for ma, mb in zip(a.members, b.members):
        for x, y in zip(ma.net.state_dict().values(),
                        mb.net.state_dict().values()):
            assert torch.equal(x, y)
    for ca, cb, ga, gb in zip(a.carries, b.carries, a.generators,
                              b.generators):
        assert torch.equal(ca.generator.get_state(),
                           cb.generator.get_state())
        assert torch.equal(ga.get_state(), gb.get_state())
    for x, y in zip(a.hparams, b.hparams):
        assert np.array_equal(x, y)
    assert [d.src.tolist() for d in a.controller.history] == \
        [d.src.tolist() for d in b.controller.history]
    assert out["async"]["staleness_max_per_member"] == [0, 0]
    assert "total_loss_1" in out["history"][0]
    with pytest.raises(TypeError, match="watchdog"):
        b.run_async(1, watchdog=object())


def test_vtrace_at_bound0_holds_the_learn_step_band():
    ref = build(small_cfg())
    ref.run(4)
    exp = build(small_cfg(ppo_kw={"correction": "vtrace"}))
    out = exp.run_async(4, staleness_bound=0, log_every=1)
    for x, y in zip(ref.net.state_dict().values(),
                    exp.net.state_dict().values()):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=0)
    for h in out["history"]:
        assert abs(h["rho_mean"] - 1) <= 1e-6
        assert abs(h["rho_max"] - 1) <= 1e-6


def test_staleness_bounds_hold_and_deep_queues_run_deep():
    out = build(small_cfg()).run_async(6, staleness_bound=1)
    assert 0 <= out["async"]["staleness_max"] <= 1
    # a long update behind a short rollout: the learner is the slower loop
    deep = small_cfg(ppo_kw={"correction": "vtrace", "n_steps": 4,
                             "n_epochs": 8, "n_minibatches": 4})
    out = build(deep).run_async(10, staleness_bound=4, queue_capacity=4,
                                log_every=1)
    info = out["async"]
    assert 1 < info["staleness_max"] <= 4
    assert np.isfinite([h["total_loss"] for h in out["history"]]).all()
    assert info["importance_ratio_max"] >= 1.0
    exp = build(small_cfg())
    for kw, match in (({"staleness_bound": -1}, "staleness_bound"),
                      ({"queue_capacity": 0}, "capacity")):
        with pytest.raises(ValueError, match=match):
            teng.AsyncRunner(exp, **kw)


def test_no_build_after_warmup_and_bound1_learns_as_sync():
    cfg = small_cfg()
    sync = build(cfg).run(8, log_every=1)
    r = teng.AsyncRunner(build(cfg), staleness_bound=1)
    r.run(2)
    with CompileCounter() as c:
        out = r.run(8, log_every=1)
    assert c.total == 0, c.events
    s_r = [h["mean_reward"] for h in sync["history"][-4:]]
    a_r = [h["mean_reward"] for h in out["history"][-4:]]
    assert np.isfinite(a_r).all()
    assert abs(float(np.mean(s_r)) - float(np.mean(a_r))) < 0.05


def test_telemetry_surface(tmp_path):
    exp = build(small_cfg())
    with RunTelemetry(str(tmp_path), alarms=True, trace=True,
                      device="cpu") as tel:
        exp.run_async(3, staleness_bound=1, log_every=1, telemetry=tel)
    events = merge_dir(str(tmp_path))
    kinds = [e["kind"] for e in events]
    assert "recompile" not in kinds and "transfer" not in kinds
    end = _event(events, "run_end")
    phases = end["phase_seconds"]
    assert phases["actor"] > 0 and phases["learner"] > 0
    assert {"queue_wait", "sync"} <= set(phases)
    assert end["async_staleness_max"] <= 1 and end["async_overlap_s"] >= 0
    tracks = {(e["span"], e["thread"]) for e in events
              if e["kind"] == "span_begin"}
    assert ("actor", "async-actor") in tracks
    assert ("learner", "MainThread") in tracks
    prom = open(tmp_path / "metrics.prom", encoding="utf-8").read()
    for name in ("queue_depth", "param_staleness", "actor_idle_s",
                 "learner_idle_s", "overlap_s", "importance_ratio_mean",
                 "importance_ratio_max"):
        assert f"rlsched_async_{name} " in prom


def test_the_actors_guard_raises_a_transfer_alarm(tmp_path, monkeypatch):
    """``Alarms.watch``: past its own warmup a sync inside is a transfer
    alarm; ``intended_sync`` nested in another leaves the mode to the
    outer scope."""
    import contextlib
    entered = []

    @contextlib.contextmanager
    def guard(device="cuda"):
        entered.append(str(device))
        yield

    monkeypatch.setattr(ttel, "no_implicit_transfers", guard)
    bus = EventBus(str(tmp_path), rank=0)
    with ttel.Alarms(bus, device="cuda") as al:
        with al.watch(0):
            pass
        with pytest.raises(ttel.AlarmError, match="transfer alarm"):
            with al.watch(1):
                raise RuntimeError("called a synchronizing CUDA operation")
    bus.close()
    assert entered == ["cuda"]
    assert [e["kind"] for e in merge_dir(str(tmp_path))] == ["transfer"]
    modes = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    monkeypatch.setattr(sentinels, "_guard_depth", 1)
    monkeypatch.setattr(sentinels, "_guard_prev", 0)
    with sentinels.intended_sync():
        with sentinels.intended_sync():
            assert modes == [0]
        assert modes == [0]
    assert modes == [0, "error"]
