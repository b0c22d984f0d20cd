"""The port's run-loop telemetry (``obs.telemetry``) against the JAX
package's.

- ``Alarms``: a ``note_build`` inside a post-warmup dispatch is a
  ``recompile`` event and a warm control is clean (the JAX geometry-
  change control's shape); amnesty lands as ``compile``; the
  slow-iteration event; torch's sync-guard error text becomes an
  ``AlarmError`` and a ``transfer`` event, any other error passes; the
  guard acts on the alarms' device past the warmup only;
- ``intended_sync``: nothing outside the guard, inside it lifts the mode
  for its scope and leaves the refcount alone;
- ``RunTelemetry`` around ``Experiment.run(3, log_every=1)`` at
  ``tests/test_obs.py``'s ``SMALL`` geometry, both packages on the JAX
  init's weights at f32, the port's rollout replaying JAX's actions and
  its update JAX's permutations: the event kinds (less JAX's warmup
  ``compile``, the recorded departure), the iteration numbers, the
  phase keys, the ``run_start``/``run_end`` fields and the
  ``metrics.prom`` series equal JAX's (the port's run alarm-clean); the
  logged metrics within 1e-5 (``tests/test_torch_algos.py``'s
  learn-step tolerance); either package's ``obs.report
  --strict-alarms`` reads each run as the other does;
- telemetry (with the flight recorder on) adds no host read to the loop;
- the slow-iteration alarm captures one profiler trace of the next
  iteration.
"""
import contextlib
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu.algos import ppo as jppo
from rlgpuschedule_tpu.algos.rollout import rollout as jrollout
from rlgpuschedule_tpu.configs import CONFIGS as JCONFIGS
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu.obs import RunTelemetry as JRunTelemetry
from rlgpuschedule_tpu.obs import report as jreport
from rlgpuschedule_tpu_torch.algos import action_dist as tdist
from rlgpuschedule_tpu_torch.algos import ppo as tppo
from rlgpuschedule_tpu_torch.algos.rollout import rollout as trollout
from rlgpuschedule_tpu_torch.analysis import sentinels
from rlgpuschedule_tpu_torch.configs import CONFIGS as TCONFIGS
from rlgpuschedule_tpu_torch.experiment import Experiment
from rlgpuschedule_tpu_torch.models import make_policy, params_from_jax
from rlgpuschedule_tpu_torch.obs import (AlarmError, Alarms, EventBus,
                                         RunTelemetry, read_events)
from rlgpuschedule_tpu_torch.obs import report as treport
from rlgpuschedule_tpu_torch.obs import telemetry as ttelemetry
from torch_jax_builds import fast_jax_build

T, E = 8, 2
GEOMETRY = dict(n_steps=T, n_epochs=1, n_minibatches=2)
CUT = dict(n_envs=E, window_jobs=16, horizon=64)
SMALL_J = dataclasses.replace(JCONFIGS["ppo-mlp-synth64"], **CUT,
                              ppo=jppo.PPOConfig(**GEOMETRY))
SMALL_T = dataclasses.replace(TCONFIGS["ppo-mlp-synth64"], **CUT,
                              ppo=tppo.PPOConfig(**GEOMETRY))
SYNC_TEXT = ("called a synchronizing CUDA operation (the error torch "
             "raises under set_sync_debug_mode('error'))")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# ---- Alarms ------------------------------------------------------------

def _kinds(path):
    return [(e["kind"], e.get("iteration")) for e in read_events(path)]


def test_recompile_alarm_on_a_build_in_a_post_warmup_dispatch(tmp_path):
    bus = EventBus(str(tmp_path), rank=0)
    with Alarms(bus, warmup_iters=1, device="cpu") as al:
        with al.dispatch(0):                 # warmup: the allowed build
            sentinels.note_build(sentinels.BUILD)
        with al.dispatch(1):                 # warm control: clean
            pass
        with al.dispatch(2):                 # a build past the warmup
            sentinels.note_build(sentinels.CAPTURE)
        with al.dispatch(3):                 # control again
            pass
    bus.close()
    events = read_events(bus.path)
    assert [(e["kind"], e["iteration"]) for e in events] == \
        [("compile", 0), ("recompile", 2)]
    assert events[0]["warmup"] is True and events[1]["events"] == 1
    assert al.registry.counter(
        "rlsched_recompile_alarms_total").value == 1


def test_expected_recompile_amnesty(tmp_path):
    bus = EventBus(str(tmp_path), rank=0)
    with Alarms(bus, warmup_iters=1, device="cpu") as al:
        with al.dispatch(0):
            sentinels.note_build(sentinels.BUILD)
        al.expect_recompile("rollback lr rescale")
        with al.dispatch(1):
            sentinels.note_build(sentinels.BUILD)
    bus.close()
    events = read_events(bus.path)
    assert [e["kind"] for e in events] == ["compile", "compile"]
    assert events[1]["expected"] == "rollback lr rescale"
    with pytest.raises(ValueError, match="outside the context"):
        with al.dispatch(2):
            pass


def test_slow_iteration_alarm(tmp_path):
    bus = EventBus(str(tmp_path), rank=0)
    with Alarms(bus, warmup_iters=0, slow_iter_s=0.5, device="cpu") as al:
        al.observe_wall(4, 0.1)
        al.observe_wall(5, 2.0)
    bus.close()
    events = read_events(bus.path)
    assert [(e["kind"], e["iteration"]) for e in events] == \
        [("slow_iteration", 5)]
    assert events[0]["threshold_s"] == 0.5 and events[0]["wall_s"] == 2.0


def test_transfer_alarm_on_the_sync_guard_error(tmp_path):
    bus = EventBus(str(tmp_path), rank=0)
    with Alarms(bus, warmup_iters=0, device="cpu") as al:
        with pytest.raises(AlarmError, match="transfer alarm") as e:
            with al.dispatch(0):
                raise RuntimeError(SYNC_TEXT)
        with pytest.raises(ValueError, match="not a sync"):
            with al.dispatch(1):
                raise ValueError("not a sync")
    bus.close()
    assert isinstance(e.value.__cause__, RuntimeError)
    events = read_events(bus.path)
    assert [e["kind"] for e in events] == ["transfer"]
    assert events[0]["error"].startswith("called a synchronizing")
    assert al.registry.counter(
        "rlsched_transfer_alarms_total").value == 1


def test_the_guard_covers_post_warmup_dispatches_on_the_alarm_device(
        tmp_path, monkeypatch):
    entered = []

    @contextlib.contextmanager
    def guard(device="cuda"):
        entered.append(str(device))
        yield

    monkeypatch.setattr(ttelemetry, "no_implicit_transfers", guard)
    bus = EventBus(str(tmp_path), rank=0)
    with Alarms(bus, warmup_iters=1, device="cuda") as al:
        for i in range(3):
            if i == 2:
                al.expect_recompile("amnesty lifts the guard")
            with al.dispatch(i):
                pass
    with Alarms(bus, warmup_iters=0, transfer_guard=False,
                device="cuda") as al:
        with al.dispatch(0):
            pass
    bus.close()
    assert entered == ["cuda"]       # dispatch 1 only


def test_intended_sync_lifts_the_mode_and_keeps_the_refcount(monkeypatch):
    with sentinels.intended_sync():          # outside the guard: nothing
        pass
    modes = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    monkeypatch.setattr(sentinels, "_guard_depth", 2)
    monkeypatch.setattr(sentinels, "_guard_prev", 0)
    with sentinels.intended_sync():
        assert modes == [0] and sentinels._guard_depth == 2
    assert modes == [0, "error"] and sentinels._guard_depth == 2


# ---- RunTelemetry against JAX's -------------------------------------------

def _jax_perms(key, n_epochs, b):
    """The permutations JAX's update engine draws from ``key``."""
    perms = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        perms.append(torch.tensor(np.asarray(jax.random.permutation(sub,
                                                                    b))))
    return perms


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three telemetered iterations in each package from the same f32
    weights; the port's rollouts replay JAX's actions and its updates
    JAX's permutations. Returns both obs dirs and run summaries."""
    root = tmp_path_factory.mktemp("telemetry")
    ej = fast_jax_build(SMALL_J)
    jp = ej.env_params
    net32 = jmake_policy("flat", jp.n_actions, dtype=jnp.float32)

    def apply32(p, o, m):
        return net32.apply(p, o, m)

    # built as Experiment.build builds its step (state and carry donated)
    step32 = jax.jit(jppo.make_train_step(apply32, jp, SMALL_J.ppo),
                     donate_argnums=(0, 1))
    params0 = jax.device_get(ej.train_state.params)
    records = []

    def recording(state, carry, traces, key, faults=None):
        # explicit host copies: the step donates what it is handed
        records.append(jax.device_get((state.params, carry, key)))
        return step32(state, carry, traces, key, faults)

    ej = dataclasses.replace(ej, apply_fn=apply32, train_step=recording)
    jdir = str(root / "jax")
    with JRunTelemetry(jdir, rank=0, alarms=True) as jt:
        jout = ej.run(iterations=3, log_every=1, telemetry=jt)

    et = Experiment.build(SMALL_T, device="cpu")
    tp = et.env_params
    net = make_policy("flat", tp.n_actions, tp.obs_shape(),
                      dtype=torch.float32, device="cpu")
    net.load_state_dict(params_from_jax(params0))
    et.train_state = tppo.make_train_state(net, SMALL_T.ppo)
    jroll = jax.jit(lambda p, c: jrollout(apply32, p, jp, ej.traces, c, T))
    learn = tppo.make_learn_step(SMALL_T.ppo)
    recorded = iter(records)

    def replay_step(state, carry, traces, generator, faults=None):
        jparams, jcarry, key = next(recorded)
        _, jtr, _ = jroll(jparams, jcarry)
        actions = iter(torch.tensor(np.asarray(jtr.action)))

        def sample(gen, logits):
            a = next(actions)
            return a, tdist.log_prob(logits, a)

        carry, tr, last = trollout(state.net, tp, traces, carry, T,
                                   sample_fn=sample, faults=faults)
        state, m = learn(state, tr, last, perms=_jax_perms(key, 1, T * E))
        return state, carry, m

    et.train_step = replay_step
    tdir = str(root / "torch")
    with RunTelemetry(tdir, rank=0, alarms=True, device="cpu") as tt:
        tout = et.run(3, log_every=1, telemetry=tt)
    return {"jax": (jdir, jout), "torch": (tdir, tout)}


def _stream(runs, side):
    return read_events(os.path.join(runs[side][0], "events.rank0.jsonl"))


# JAX's compile-counting events: the port's eager step builds no program,
# so its stream has no warmup ``compile`` (the recorded departure); and
# JAX's count past the warmup depends on its compile cache (a warm cache
# fires a trace event per dispatch under jax 0.9, ROADMAP.md queue 3)
JAX_COMPILE_KINDS = ("compile", "recompile")


def test_event_kinds_and_iterations_match_jax(runs):
    jev, tev = _stream(runs, "jax"), _stream(runs, "torch")
    jkinds = [e["kind"] for e in jev]
    assert jkinds.count("compile") == 1       # JAX's warmup build
    assert [e["kind"] for e in tev] == [k for k in jkinds
                                        if k not in JAX_COMPILE_KINDS]
    assert not {"compile", "recompile", "transfer"} & {
        e["kind"] for e in tev}
    assert [e["iteration"] for e in tev if e["kind"] == "iteration"] == \
        [e["iteration"] for e in jev if e["kind"] == "iteration"] == [0, 1, 2]


def test_phase_keys_and_run_fields_match_jax(runs):
    jev, tev = _stream(runs, "jax"), _stream(runs, "torch")
    for kind in ("run_start", "run_end", "iteration"):
        jrows = [e for e in jev if e["kind"] == kind]
        trows = [e for e in tev if e["kind"] == kind]
        assert len(trows) == len(jrows) >= 1, kind
        for j, t in zip(jrows, trows):
            assert set(t) == set(j), kind
            if kind != "run_start":
                key = "phases" if kind == "iteration" else "phase_seconds"
                assert set(t[key]) == set(j[key]) == {"step", "sync"}
    start = {k: v for k, v in next(e for e in tev
                                   if e["kind"] == "run_start").items()
             if k not in ("v", "rank", "pid", "seq", "mono", "wall")}
    assert start == {k: v for k, v in next(
        e for e in jev if e["kind"] == "run_start").items() if k in start}
    assert start["loop"] == "experiment" and start["fused_chunk"] == 1


def _prom_series(obs_dir):
    text = open(os.path.join(obs_dir, "metrics.prom")).read()
    return {re.split(r"[ {]", line)[0]: line for line in text.splitlines()
            if line and not line.startswith("#")}


def test_prom_counters_match_jax(runs):
    js, ts = _prom_series(runs["jax"][0]), _prom_series(runs["torch"][0])
    assert set(ts) == set(js)
    for name in ("rlsched_iterations_total", "rlsched_env_steps_total",
                 "rlsched_transfer_alarms_total",
                 "rlsched_slow_iteration_alarms_total"):
        assert ts[name] == js[name], name
    assert ts["rlsched_iterations_total"] == "rlsched_iterations_total 3"
    assert ts["rlsched_env_steps_total"] == "rlsched_env_steps_total 48"
    assert ts["rlsched_recompile_alarms_total"] == \
        "rlsched_recompile_alarms_total 0"


def test_logged_metrics_match_jax(runs):
    jm = [e["metrics"] for e in _stream(runs, "jax")
          if e["kind"] == "iteration"]
    tm = [e["metrics"] for e in _stream(runs, "torch")
          if e["kind"] == "iteration"]
    assert [list(m) for m in tm] == [list(m) for m in jm]
    for j, t in zip(jm, tm):
        np.testing.assert_allclose([t[k] for k in j], [j[k] for k in j],
                                   rtol=1e-5, atol=1e-5)
    # the event carries what the loop logged
    hist = runs["torch"][1]["history"]
    assert [{k: v for k, v in h.items() if k != "iteration"}
            for h in hist] == tm


@pytest.mark.parametrize("run", ["jax", "torch"])
def test_either_report_reads_either_run_alike(runs, run, capsys):
    """Both packages' ``obs.report --strict-alarms`` give the same exit
    code and the same alarm summary on each run; the port's run is
    clean."""
    got = {}
    for reader, module in (("jax", jreport), ("torch", treport)):
        rc = module.main([runs[run][0], "--strict-alarms"])
        alarms = [x for x in capsys.readouterr().out.splitlines()
                  if x.startswith("alarms:")]
        got[reader] = (rc, alarms)
    assert got["torch"] == got["jax"]
    if run == "torch":
        assert got["torch"][0] == 0 and "(clean)" in got["torch"][1][0]


# ---- the loop's host reads ----------------------------------------------

_READS = ("tolist", "item", "__bool__", "__float__", "__int__", "numpy",
          "cpu")


@contextlib.contextmanager
def _counting_reads(counts):
    real = {n: getattr(torch.Tensor, n) for n in _READS}

    def wrap(name):
        def read(self, *a, **k):
            counts[name] = counts.get(name, 0) + 1
            return real[name](self, *a, **k)
        return read

    for n in _READS:
        setattr(torch.Tensor, n, wrap(n))
    try:
        yield
    finally:
        for n, f in real.items():
            setattr(torch.Tensor, n, f)


def test_telemetry_adds_no_host_read(tmp_path):
    counts = {}
    for label in ("bare", "telemetry"):
        exp = Experiment.build(SMALL_T, device="cpu")
        counts[label] = {}
        with contextlib.ExitStack() as stack:
            tel = None
            if label == "telemetry":
                tel = stack.enter_context(RunTelemetry(
                    str(tmp_path), alarms=True, trace=True, device="cpu"))
            with _counting_reads(counts[label]):
                exp.run(3, log_every=1, telemetry=tel)
    assert counts["telemetry"] == counts["bare"]
    assert counts["bare"]["tolist"] == 3      # one per logged iteration
    events = read_events(os.path.join(str(tmp_path), "events.rank0.jsonl"))
    assert any(e["kind"] == "span_begin" for e in events)


def test_slow_iteration_captures_one_profile_of_the_next(tmp_path):
    exp = Experiment.build(SMALL_T, device="cpu")
    with RunTelemetry(str(tmp_path), alarms=True, slow_iter_s=1e-9,
                      device="cpu") as tel:
        exp.run(3, log_every=1, telemetry=tel)
    events = read_events(os.path.join(str(tmp_path), "events.rank0.jsonl"))
    kinds = [(e["kind"], e.get("iteration")) for e in events]
    assert [i for k, i in kinds if k == "slow_iteration"] == [0, 1, 2]
    assert [i for k, i in kinds if k == "profile_captured"] == [1]
    files = os.listdir(tmp_path / "profile")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert treport.main([str(tmp_path), "--strict-alarms"]) == 1
