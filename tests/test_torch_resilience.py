"""Resilience on one host, the port against the JAX package: the
divergence watchdog, fault injection, heartbeats and the gang
supervisor's logic, at ``tests/test_resilience.py``'s sizes (``SMALL``,
``CLI_FAST``), so the JAX programs built here are the ones that file
builds.

- ``parse_fault``, the watchdog's verdicts and reasons, the heartbeat
  files and staleness, ``RestartPolicy``'s seeded delays and the
  ``Supervisor``'s decisions (every scenario of JAX's ``TestSupervisor``,
  against identical fake launchers) are plain Python: each package runs
  the same inputs and must give the same outputs, events and log lines.
  No test sleeps: clocks and sleeps are injected.
- A ``nan-grad`` fault rolls the train CLI's run and a population's run
  back as JAX's do: the same ``RollbackEvent`` fields (the train steps
  and iterations are counted alike), the same stderr lines, the same
  retained checkpoint steps. Whose training numbers differ (the packages
  draw from different random streams) is not compared.
- A corrupted checkpoint falls back to the same previous step in both
  stores, with and without rewritten checksums.
- The port's own contracts: the restored parameters are the
  checkpoint's bits, a faulted run retried twice is bit for bit, the
  retry's streams differ from the diverged ones, a poison without a
  watchdog is real, and the train CLI refuses what JAX's refuses, in its
  words.
"""
import contextlib
import dataclasses
import io
import math
import os
import shutil
import types

import numpy as np
import pytest
import torch

from rlgpuschedule_tpu import checkpoint as jckpt
from rlgpuschedule_tpu import experiment as jexp
from rlgpuschedule_tpu import resilience as jres
from rlgpuschedule_tpu import train as jtrain
from rlgpuschedule_tpu.algos import PPOConfig as JPPOConfig
from rlgpuschedule_tpu.configs import CONFIGS as JCONFIGS
from rlgpuschedule_tpu.parallel import PBTConfig as JPBTConfig
from rlgpuschedule_tpu_torch import resilience as tres
from rlgpuschedule_tpu_torch import train as ttrain
from rlgpuschedule_tpu_torch.algos import PPOConfig
from rlgpuschedule_tpu_torch.checkpoint import (STATE_FILE, Checkpointer,
                                                CheckpointRestoreError)
from rlgpuschedule_tpu_torch.configs import CONFIGS
from rlgpuschedule_tpu_torch.experiment import (Experiment,
                                                PopulationExperiment)
from rlgpuschedule_tpu_torch.obs import RunTelemetry, read_events
from rlgpuschedule_tpu_torch.parallel import PBTConfig

# the tensors here are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

# tests/test_resilience.py's shapes
CLI_FAST = ["--iterations", "4", "--n-envs", "4", "--n-nodes", "2",
            "--gpus-per-node", "4", "--window-jobs", "16",
            "--log-every", "1", "--horizon", "64", "--queue-len", "4",
            "--n-steps", "8", "--n-epochs", "1", "--n-minibatches", "2"]
NAN_GRAD = ["--ckpt-every", "1", "--fault", "nan-grad@2",
            "--max-rollbacks", "2"]
FAST = dataclasses.replace(
    CONFIGS["ppo-mlp-synth64"], n_envs=4, n_nodes=2, gpus_per_node=4,
    window_jobs=16, horizon=64, queue_len=4, iterations=4,
    ppo=dataclasses.replace(CONFIGS["ppo-mlp-synth64"].ppo, n_steps=8,
                            n_epochs=1, n_minibatches=2))
POP_J = dataclasses.replace(
    JCONFIGS["ppo-mlp-synth64"], n_envs=4, window_jobs=16, horizon=64,
    ppo=JPPOConfig(n_steps=8, n_epochs=1, n_minibatches=2))
POP_T = dataclasses.replace(
    CONFIGS["ppo-mlp-synth64"], n_envs=4, window_jobs=16, horizon=64,
    ppo=PPOConfig(n_steps=8, n_epochs=1, n_minibatches=2))
# one member dead at 1 (PBT's job), every member at 2 (the watchdog's)
POP_SPECS = ("nan-grad@1:rank=1", "nan-grad@2:rank=0", "nan-grad@2:rank=1")

PACKAGES = {"jax": jres, "torch": tres}


def _said(text: str) -> list[str]:
    """The resilience and checkpoint lines of a stderr capture."""
    return [ln for ln in text.splitlines()
            if ln.startswith(("fault-injection:", "watchdog:",
                              "checkpoint:"))]


def _all_members(pkg):
    """An injector whose ``nan-grad`` fires every spec due at an
    iteration: one spec poisons one member, so this is how a test makes
    every member's fitness non-finite."""
    class AllMembers(pkg.FaultInjector):
        def poison_nan_member(self, pop, iteration, metrics):
            # the hook hands back the metrics it was given when no spec
            # is due any more
            out = super().poison_nan_member(pop, iteration, metrics)
            while out is not metrics:
                metrics = out
                out = super().poison_nan_member(pop, iteration, metrics)
            return out
    return AllMembers


# ---- the JAX package's runs, once per worker --------------------------------

@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    """JAX's train CLI at CLI_FAST with ``nan-grad@2`` under a watchdog:
    its summary, its stderr lines and its checkpoint directory."""
    d = str(tmp_path_factory.mktemp("jax_cli") / "ck")
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        summary = jtrain.main(["--config", "ppo-mlp-synth64", *CLI_FAST,
                               "--ckpt-dir", d, *NAN_GRAD])
    return {"summary": summary, "said": _said(err.getvalue()), "dir": d}


@pytest.fixture(scope="module")
def jax_pop():
    """JAX's 2-member population: member 1 poisoned at 1, both at 2,
    under a watchdog of one rollback."""
    import tempfile
    pop = jexp.PopulationExperiment.build(
        POP_J, n_pop=2, mesh=None, pbt_cfg=JPBTConfig(ready_iters=1, seed=0))
    inj = _all_members(jres)([jres.parse_fault(s) for s in POP_SPECS])
    err = io.StringIO()
    with tempfile.TemporaryDirectory() as d, \
            contextlib.redirect_stderr(err), \
            jckpt.Checkpointer(os.path.join(d, "ck")) as ck:
        out = pop.run(iterations=4, log_every=1, ckpt=ck, ckpt_every=2,
                      injector=inj,
                      watchdog=jres.DivergenceWatchdog(max_rollbacks=1))
    return {"out": out, "said": _said(err.getvalue())}


@pytest.fixture(scope="module")
def torch_cli(tmp_path_factory):
    """The port's train CLI on the same flags, on the CPU."""
    d = str(tmp_path_factory.mktemp("torch_cli") / "ck")
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        summary = ttrain.main(["--config", "ppo-mlp-synth64", *CLI_FAST,
                               "--ckpt-dir", d, *NAN_GRAD,
                               "--device", "cpu"])
    return {"summary": summary, "said": _said(err.getvalue()), "dir": d}


# ---- parse_fault ------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "nan-grad@3", "kill-rank@2:rank=1", "corrupt-ckpt@7",
    "lose-rank@2:rank=1", " nan-grad@0 ", "nan-grad@4:rank=-1",
    "nan-grad@1: rank = 2"])
def test_parse_fault_reads_a_spec_as_jax_does(spec):
    j, t = jres.parse_fault(spec), tres.parse_fault(spec)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("bad", [
    "nan@3", "nan-grad", "nan-grad@x", "nan-grad@3:bogus=2", "@2", "",
    "nan-grad@-1", "nan-grad@3:rank=x", "kill-rank@"])
def test_parse_fault_refuses_a_bad_spec_in_jaxs_words(bad):
    with pytest.raises(ValueError) as je:
        jres.parse_fault(bad)
    with pytest.raises(ValueError) as te:
        tres.parse_fault(bad)
    assert str(te.value) == str(je.value)
    assert "fault" in str(te.value)


def test_fault_kinds_and_exit_codes_are_jaxs():
    from rlgpuschedule_tpu.resilience import faults as jfaults
    from rlgpuschedule_tpu_torch.resilience import faults as tfaults
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert (tres.KILL_RANK_EXIT, tres.LOSE_RANK_EXIT) == \
        (jres.KILL_RANK_EXIT, jres.LOSE_RANK_EXIT) == (17, 23)
    assert tres.__all__ == [n for n in jres.__all__
                            if n != "SubprocessGangLauncher"]


# ---- the watchdog's verdicts ------------------------------------------------

NAN, INF = float("nan"), float("inf")
STREAMS = {
    "finite": [{"total_loss": 0.5, "mean_reward": -1.0}] * 3,
    "nan_loss": [{"total_loss": 0.5}, {"total_loss": NAN}],
    "inf_reward": [{"total_loss": 0.5, "mean_reward": INF}],
    "neg_inf_first_key": [{"pg_loss": -INF, "total_loss": NAN}],
    "blowup_after_ema": [{"total_loss": 1.0}] * 5 + [{"total_loss": 1e6}],
    "negative_blowup": [{"total_loss": -2.0}] * 3 + [{"total_loss": -1e9}],
    "first_large_is_no_blowup": [{"total_loss": 1e9},
                                 {"total_loss": 1e9}],
    "ema_moves": [{"total_loss": x} for x in (1.0, 50.0, 3.0, 400.0, 2e5)],
    "no_loss_key": [{"mean_reward": 1.0}, {"mean_reward": 1e12}],
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_watchdog_verdicts_match_jax(name):
    j = jres.DivergenceWatchdog(blowup_factor=100.0)
    t = tres.DivergenceWatchdog(blowup_factor=100.0)
    got = [(t.check(m), j.check(m)) for m in STREAMS[name]]
    assert all(a == b for a, b in got), got
    assert t._loss_ema == j._loss_ema or (
        t._loss_ema is not None and math.isclose(t._loss_ema, j._loss_ema))


@pytest.mark.parametrize("fitness", [
    [NAN, 1.0], [NAN, INF], [], [1.0, 2.0], [-INF, NAN, NAN], [0.0]])
def test_check_population_matches_jax(fitness):
    want = jres.DivergenceWatchdog().check_population(
        np.asarray(fitness, np.float32))
    t = tres.DivergenceWatchdog()
    assert t.check_population(torch.tensor(fitness, dtype=torch.float32)) \
        == want
    assert t.check_population(np.asarray(fitness, np.float32)) == want
    assert t.check_population(list(fitness)) == want


def test_an_exhausted_budget_raises_jaxs_error():
    with pytest.raises(jres.DivergenceError) as je:
        jres.DivergenceWatchdog(max_rollbacks=0).rollback(
            None, None, 3, "non-finite total_loss=nan")
    with pytest.raises(tres.DivergenceError) as te:
        tres.DivergenceWatchdog(max_rollbacks=0).rollback(
            None, None, 3, "non-finite total_loss=nan")
    assert str(te.value) == str(je.value)
    assert "max_rollbacks=0" in str(te.value)
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError, match="max_rollbacks must be >= 0"):
            pkg.DivergenceWatchdog(max_rollbacks=-1)


# ---- heartbeats -------------------------------------------------------------

def test_heartbeat_files_cross_between_the_packages(tmp_path):
    mono = [100.0]
    clock = lambda: mono[0]   # noqa: E731
    tres.HeartbeatWriter(str(tmp_path), rank=0, clock=clock).beat(4)
    jres.HeartbeatWriter(str(tmp_path), rank=1, clock=clock).beat(7)
    reads = [pkg.HeartbeatMonitor(str(tmp_path), 3, 60.0,
                                  clock=clock).read()
             for pkg in PACKAGES.values()]
    assert reads[0] == reads[1] == {0: (4, 100.0), 1: (7, 100.0)}
    assert (tmp_path / "rank0.hb").read_text() == "4 100.0"


@pytest.mark.parametrize("timeout", [5.0, 0.05])
def test_staleness_and_the_monotonic_clock_match_jax(tmp_path, timeout):
    """Writers and monitors of both packages on one injected monotonic
    clock: staleness moves only with it, ranks without a file are judged
    from the monitor's (re)start, and a beat makes a rank fresh."""
    mono = [100.0]
    clock = lambda: mono[0]   # noqa: E731
    seen = {}
    for name, pkg in PACKAGES.items():
        d = tmp_path / name
        hb = pkg.HeartbeatWriter(str(d), rank=0, clock=clock)
        mono[0] = 100.0
        hb.beat(0)
        mon = pkg.HeartbeatMonitor(str(d), n_ranks=2, timeout_s=timeout,
                                   clock=clock)
        out = [mon.stale_ranks()]
        mono[0] += 0.98 * timeout
        out.append(mon.stale_ranks())
        mono[0] += 0.04 * timeout
        out.append(mon.stale_ranks())
        mon.restart()
        out.append(mon.stale_ranks())
        hb.beat(1)
        out.append(mon.stale_ranks())
        out.append(mon.stale_ranks(now=mono[0] + 2 * timeout))
        seen[name] = out
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][:5] == [[], [], [0, 1], [0], []]


def test_a_torn_temporary_never_surfaces(tmp_path):
    for name, pkg in PACKAGES.items():
        d = tmp_path / name
        pkg.HeartbeatWriter(str(d), rank=0, clock=lambda: 7.0).beat(3)
        (d / "rank0.hb.tmp.99999").write_text("2 12")
        (d / "rank1.hb").write_text("garbage")
        mon = pkg.HeartbeatMonitor(str(d), n_ranks=2, timeout_s=60.0,
                                   clock=lambda: 8.0)
        assert mon.read() == {0: (3, 7.0)}
        assert mon.stale_ranks() == []


# ---- RestartPolicy ----------------------------------------------------------

def _fake_time():
    t = [0.0]
    return (lambda: t[0]), (lambda s: t.__setitem__(0, t[0] + s)), t


@pytest.mark.parametrize("seed,jitter", [(0, 0.25), (7, 0.5), (123, 0.0),
                                         (2**31, 1.0)])
def test_restart_policy_delays_are_jaxs(seed, jitter):
    """The same seed gives JAX's delays exactly (``random.Random``), with
    the exponential growth, the cap and the budget arithmetic."""
    runs = []
    for pkg in PACKAGES.values():
        clock, _, t = _fake_time()
        pol = pkg.RestartPolicy(5, backoff_s=1.0, backoff_max_s=4.0,
                                jitter_frac=jitter, jitter_seed=seed,
                                clock=clock)
        seq = []
        for _ in range(6):
            t[0] += 1000.0
            seq.append((pol.record_failure(), pol.next_delay(),
                        pol.exhausted()))
        runs.append(seq)
    assert runs[0] == runs[1]
    assert [c for c, _, _ in runs[1]] == [1] * 6
    assert [e for _, _, e in runs[1]] == [False] * 5 + [True]
    if jitter == 0.0:
        assert [d for _, d, _ in runs[1]] == [1.0, 2.0, 4.0, 4.0, 4.0, 4.0]


def test_storm_charges_double_as_in_jax():
    runs = []
    for pkg in PACKAGES.values():
        clock, _, t = _fake_time()
        pol = pkg.RestartPolicy(10, backoff_s=1.0, clock=clock)
        out = [pol.record_failure()]
        pol.next_delay()
        t[0] += 0.5
        out.append(pol.record_failure())
        t[0] += 1000.0
        out.append(pol.record_failure())
        runs.append((out, pol.failures, pol.spent, pol.storm_charges))
    assert runs[0] == runs[1] == ([1, 2, 1], 3, 4, 1)
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError, match="max_restarts"):
            pkg.RestartPolicy(-1)


# ---- the Supervisor ---------------------------------------------------------

def _fake_launcher(pkg):
    class FakeGang(pkg.Gang):
        def __init__(self, codes):
            self._codes = codes
            self.killed = False

        def poll(self):
            return list(self._codes)

        def kill(self):
            self.killed = True

        def outputs(self):
            return [f"rank {r} log" for r in range(len(self._codes))]

    class FakeLauncher(pkg.Launcher):
        """Each launch() pops the next exit-code vector; the completed
        steps are a plain dict."""

        def __init__(self, world, script, steps):
            self.world_size = world
            self._script = list(script)
            self._steps = dict(steps)
            self.plans = []
            self.gangs = []

        def launch(self, plan):
            self.plans.append(plan)
            self.gangs.append(FakeGang(self._script.pop(0)))
            return self.gangs[-1]

        def completed_steps(self, ranks):
            return {r: self._steps[r] for r in ranks if r in self._steps}

    return FakeLauncher


class _Bus:
    def __init__(self):
        self.events = []

    def emit(self, kind, **fields):
        self.events.append((kind, fields))


class _StaleRankOne:
    """A monitor whose rank 1 goes stale at its second look."""
    timeout_s = 1.0

    def __init__(self):
        self.calls = 0

    def stale_ranks(self):
        self.calls += 1
        return [1] if self.calls > 1 else []


LOSE = 23
SCENARIOS = {
    "same_size_restart_from_min_step": (2, [[0, 9], [0, 0]],
                                        {0: 3, 1: 2}, 2, {}),
    "fresh_restart_when_a_rank_never_checkpointed": (
        2, [[17, None], [0, 0]], {0: 1}, 2, {}),
    "permanent_loss_shrinks": (3, [[None, LOSE, None], [0, 0]],
                               {0: 3, 1: 3, 2: 2}, 2, {}),
    "permanent_loss_wins_attribution": (3, [[1, LOSE, 1], [0, 0]],
                                        {0: 2, 1: 2, 2: 2}, 2, {}),
    "shrink_without_survivor_steps_is_fresh": (
        3, [[None, LOSE, None], [0, 0]], {0: 3}, 2, {}),
    "crash_loop_storm_terminates_early": (2, [[17, None]] * 10,
                                          {0: 0, 1: 0}, 4, {}),
    "shrink_below_min_world_gives_up": (2, [[None, LOSE]], {0: 2, 1: 2}, 5,
                                        {"min_world": 2}),
    "zero_budget_reports_first_failure": (2, [[17, None]], {}, 0, {}),
    "deadline_raises_supervisor_timeout": (
        2, [[None, None]] * 10, {}, 2,
        {"deadline_s": 0.05, "poll_interval_s": 0.01}),
    "heartbeat_detection": (2, [[None, None], [0, 0]], {0: 2, 1: 2}, 2,
                            {"poll_interval_s": 0.0, "heartbeat": True}),
}


def _supervise(pkg, world, script, steps, budget, kw):
    clock, sleep, _ = _fake_time()
    kw = dict(kw)
    monitors = []
    if kw.pop("heartbeat", False):
        def factory(world):
            monitors.append(_StaleRankOne())
            return monitors[-1]
        kw["monitor_factory"] = factory
    launcher = _fake_launcher(pkg)(world, script, steps)
    bus, logs = _Bus(), []
    sup = pkg.Supervisor(launcher, pkg.RestartPolicy(
        budget, backoff_s=0.001, clock=clock), sleep=sleep, clock=clock,
        log=logs.append, bus=bus, **kw)
    try:
        res = dataclasses.asdict(sup.run())
    except pkg.SupervisorTimeout as e:
        res = {"timeout": str(e)}
    return {"result": res,
            "plans": [dataclasses.astuple(p) for p in launcher.plans],
            "killed": [g.killed for g in launcher.gangs],
            "events": bus.events, "logs": logs,
            "monitors": len(monitors)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_supervisor_decides_as_jaxs_does(name):
    """The same launcher script gives the same SupervisorResult, launch
    plans, kills, bus events (kinds and fields, in order) and log lines
    under both packages."""
    j = _supervise(jres, *SCENARIOS[name])
    t = _supervise(tres, *SCENARIOS[name])
    assert t == j
    res = t["result"]
    if name == "same_size_restart_from_min_step":
        assert res["outcome"] == "completed" and res["restarts"] == 1
        assert t["plans"][1] == (2, 1, 2, None) and t["killed"][0]
    elif name == "permanent_loss_shrinks":
        assert t["plans"][1] == (2, 1, 2, (0, 2)) and res["world_size"] == 2
    elif name == "crash_loop_storm_terminates_early":
        assert res["outcome"] == "gave_up" and len(t["plans"]) == 3
        assert (res["budget_spent"], res["storm_charges"]) == (5, 2)
    elif name == "deadline_raises_supervisor_timeout":
        assert "deadline" in res["timeout"] and t["killed"][0]
    elif name == "heartbeat_detection":
        assert res["events"][0]["detected_by"] == "heartbeat>1.0s"
        assert t["monitors"] == 2
    assert [k for k, _ in t["events"]][0] == "gang_launch"


def test_the_supervisor_modules_are_plain_python():
    import ast
    import rlgpuschedule_tpu_torch.resilience as pkg
    root = os.path.dirname(pkg.__file__)
    for name in ("faults", "heartbeat", "supervisor", "watchdog"):
        tree = ast.parse(open(os.path.join(root, f"{name}.py")).read())
        top = [n for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        mods = [a.name for n in top if isinstance(n, ast.Import)
                for a in n.names]
        mods += [n.module or "" for n in top
                 if isinstance(n, ast.ImportFrom)]
        assert not any(m.split(".")[0] in ("torch", "numpy") for m in mods)
    assert not hasattr(tres, "SubprocessGangLauncher")


# ---- nan-grad rollback: the single run --------------------------------------

def test_the_cli_rolls_back_as_jaxs_does(jax_cli, torch_cli):
    """``train --max-rollbacks 2 --fault nan-grad@2``: one rollback with
    JAX's event, JAX's stderr lines and JAX's retained steps."""
    j, t = jax_cli["summary"], torch_cli["summary"]
    assert t["rollbacks"] == j["rollbacks"] == 1
    assert t["rollback_events"] == j["rollback_events"]
    assert t["rollback_events"][0] == {
        "iteration": 2, "restored_step": 4, "resume_iteration": 2,
        "n_rollback": 1, "lr_scale": 0.5,
        "reason": "non-finite total_loss=nan"}
    assert torch_cli["said"] == jax_cli["said"]
    assert t["iterations"] == j["iterations"] == 4
    assert math.isfinite(t["env_steps_per_sec"])
    assert Checkpointer(torch_cli["dir"]).all_steps() == \
        jckpt.Checkpointer(jax_cli["dir"]).all_steps() == [4, 6, 8]


def _watched(tmp_path, specs=("nan-grad@2",), max_rollbacks=2, **kw):
    """The library run the CLI makes, with the parameters restored by
    each rollback snapshotted just after the restore."""
    exp = Experiment.build(FAST, device="cpu")
    restored = []
    restore = exp.restore_checkpoint

    def spy(ck, *a, **k):
        meta = restore(ck, *a, **k)
        restored.append((ck.last_restored_step, {
            n: v.clone() for n, v in exp.net.state_dict().items()}))
        return meta

    exp.restore_checkpoint = spy
    wd = tres.DivergenceWatchdog(max_rollbacks=max_rollbacks)
    inj = tres.FaultInjector([tres.parse_fault(s) for s in specs])
    kw.setdefault("ckpt_every", 1)
    kw.setdefault("log_every", 1)
    with Checkpointer(str(tmp_path)) as ck:
        out = exp.run(ckpt=ck, watchdog=wd, injector=inj, **kw)
    return exp, out, restored


def test_the_library_run_rolls_back_to_the_checkpoints_bits(tmp_path,
                                                            jax_cli):
    exp, out, restored = _watched(tmp_path / "ck")
    assert out["rollback_events"] == jax_cli["summary"]["rollback_events"]
    assert [h["iteration"] for h in out["history"]] == [0, 1, 2, 3]
    assert all(math.isfinite(v) for h in out["history"] for v in h.values())
    assert all(torch.isfinite(p).all() for p in exp.net.parameters())
    assert exp.iteration == 4 and exp.step == 8
    (step, params), = restored
    saved = torch.load(os.path.join(tmp_path, "ck", str(step), STATE_FILE),
                       weights_only=True)["policy"]
    assert step == 4 and params.keys() == saved.keys()
    for n, v in params.items():
        assert torch.equal(v, saved[n]), n
    lr = exp.train_state.opt.param_groups[0]["lr"]
    assert lr == FAST.ppo.lr * 0.5


def test_a_faulted_run_retries_bit_for_bit(tmp_path):
    a, out_a, _ = _watched(tmp_path / "a")
    b, out_b, _ = _watched(tmp_path / "b")
    assert out_a["history"] == out_b["history"]
    for x, y in zip(a.net.state_dict().values(), b.net.state_dict().values()):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(a.carry.generator.get_state(),
                       b.carry.generator.get_state())


def test_the_retry_draws_from_other_streams():
    """``fold_key(n)`` moves both generators off the restored streams,
    to streams fixed by the restored state and ``n``."""
    exp = Experiment.build(FAST, device="cpu")
    gens = (exp.carry.generator, exp.generator)
    before = [g.get_state().clone() for g in gens]
    exp.fold_key(1)
    once = [g.get_state().clone() for g in gens]
    for g, s in zip(gens, before):
        g.set_state(s)
    exp.fold_key(1)
    again = [g.get_state().clone() for g in gens]
    for g, s in zip(gens, before):
        g.set_state(s)
    exp.fold_key(2)
    other = [g.get_state() for g in gens]
    for b, o, a, x in zip(before, once, again, other):
        assert torch.equal(o, a)
        assert not torch.equal(o, b) and not torch.equal(o, x)


def test_without_a_watchdog_the_poison_is_real():
    exp = Experiment.build(FAST, device="cpu")
    out = exp.run(2, log_every=1, injector=tres.FaultInjector(
        [tres.parse_fault("nan-grad@0")]))
    assert math.isnan(out["history"][0]["total_loss"])
    assert not all(torch.isfinite(p).all() for p in exp.net.parameters())


def test_a_spent_budget_gives_up_cleanly(tmp_path):
    with pytest.raises(tres.DivergenceError,
                       match=r"diverged at iteration 2 .* after 1 "
                             r"rollback\(s\); max_rollbacks=1 exhausted"):
        _watched(tmp_path, specs=("nan-grad@1", "nan-grad@2"),
                 max_rollbacks=1)


def test_the_watchdog_needs_a_store_in_jaxs_words():
    with pytest.raises(ValueError) as je:
        jexp.Experiment.run(types.SimpleNamespace(cfg=None), 1,
                            watchdog=jres.DivergenceWatchdog())
    exp = Experiment.build(FAST, device="cpu")
    with pytest.raises(ValueError) as te:
        exp.run(1, watchdog=tres.DivergenceWatchdog())
    assert str(te.value) == str(je.value)
    assert exp.iteration == 0


def test_a_fused_run_rolls_back_to_a_chunk_boundary(tmp_path):
    """``fused_chunk=2``: the boundary iteration 1 is poisoned, the store
    holds only the target saved before the call (iteration -1), so the
    retry starts at 0 and the call still ends at 4."""
    exp, out, restored = _watched(tmp_path / "ck", specs=("nan-grad@1",),
                                  fused_chunk=2, ckpt_every=2,
                                  log_every=2)
    assert out["rollback_events"][0] | {"reason": None} == {
        "iteration": 1, "restored_step": 0, "resume_iteration": 0,
        "n_rollback": 1, "lr_scale": 0.5, "reason": None}
    assert [h["iteration"] for h in out["history"]] == [1, 3]
    assert exp.iteration == 4 and restored[0][0] == 0


def test_a_resumed_run_rolls_back_inside_its_own_call(tmp_path):
    """Iterations count over the experiment's life: after 2 iterations
    and a save, a second call of 2 rolls ``nan-grad@3`` back to iteration
    2's checkpoint and ends at 4."""
    exp = Experiment.build(FAST, device="cpu")
    with Checkpointer(str(tmp_path)) as ck:
        exp.run(2, ckpt=ck, ckpt_every=2)
        out = exp.run(2, ckpt=ck, ckpt_every=1,
                      watchdog=tres.DivergenceWatchdog(),
                      injector=tres.FaultInjector(
                          [tres.parse_fault("nan-grad@3")]))
    assert out["rollback_events"][0]["restored_step"] == 6
    assert out["rollback_events"][0]["resume_iteration"] == 3
    assert exp.iteration == 4


def test_telemetry_settles_a_rolled_back_iteration(tmp_path):
    """Under the alarms: the rolled-back iteration has no ``iteration``
    event, the watchdog's ``rollback`` event is on the bus, the retry's
    step raises no alarm and ``run_end`` counts the rollback."""
    exp = Experiment.build(FAST, device="cpu")
    with RunTelemetry(str(tmp_path / "obs"), alarms=True,
                      device="cpu") as tel, \
            Checkpointer(str(tmp_path / "ck")) as ck:
        exp.run(4, log_every=1, ckpt=ck, ckpt_every=1, telemetry=tel,
                watchdog=tres.DivergenceWatchdog(bus=tel.bus),
                injector=tres.FaultInjector(
                    [tres.parse_fault("nan-grad@2")], bus=tel.bus))
        assert tel.alarms._amnesty is None
    events = read_events(tel.bus.path)
    kinds = [e["kind"] for e in events if e["kind"] not in
             ("ckpt_save", "ckpt_restore")]
    assert kinds == ["run_start", "iteration", "iteration", "fault",
                     "rollback", "iteration", "iteration", "run_end"]
    assert events[-1]["rollbacks"] == 1
    rb = next(e for e in events if e["kind"] == "rollback")
    assert (rb["iteration"], rb["restored_step"]) == (2, 4)


# ---- nan-grad: the population -----------------------------------------------

def _pop(specs, injector=tres.FaultInjector, ready=1):
    pop = PopulationExperiment.build(
        POP_T, n_pop=2, device="cpu",
        pbt_cfg=PBTConfig(ready_iters=ready, seed=0))
    return pop, injector([tres.parse_fault(s) for s in specs])


def test_the_population_rolls_back_as_jaxs_does(tmp_path, jax_pop):
    pop, inj = _pop(POP_SPECS, _all_members(tres))
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            Checkpointer(str(tmp_path / "ck")) as ck:
        out = pop.run(4, log_every=1, ckpt=ck, ckpt_every=2, injector=inj,
                      watchdog=tres.DivergenceWatchdog(max_rollbacks=1))
    j = jax_pop["out"]
    assert out["rollbacks"] == j["rollbacks"] == 1
    assert out["rollback_events"] == j["rollback_events"]
    assert out["rollback_events"][0]["reason"] == \
        "all 2 members non-finite (fitness=[nan, nan])"
    assert _said(err.getvalue()) == jax_pop["said"]
    assert out["pbt_events"] == j["pbt_events"] == 4
    assert [h["iteration"] for h in out["history"]] == \
        [h["iteration"] for h in j["history"]] == [0, 1, 2, 3]
    assert np.isfinite(out["final_fitness"]).all()
    assert pop.iteration == 4
    assert pop.hparams.lr.dtype == np.float32


def test_one_dead_member_is_pbts_job(tmp_path):
    """``nan-grad@1:rank=1`` with a PBT round after it: member 1 is
    re-seeded from member 0 by the exploit and the watchdog never fires
    (JAX's ``test_population_run_recovers_injected_member_nan``)."""
    pop, inj = _pop(["nan-grad@1:rank=1"])
    seeded = {}
    update = pop.controller.maybe_update

    def spy(g, members, hparams):
        out = update(g, members, hparams)
        if g == 1:
            seeded["src"] = out[2].src.tolist()
            seeded["equal"] = all(torch.equal(x, y) for x, y in zip(
                members[0].net.parameters(), members[1].net.parameters()))
        return out

    pop.controller.maybe_update = spy
    with Checkpointer(str(tmp_path)) as ck:
        out = pop.run(4, log_every=1, ckpt=ck, ckpt_every=2, injector=inj,
                      watchdog=tres.DivergenceWatchdog(max_rollbacks=1))
    assert out["rollbacks"] == 0 and seeded == {"src": [0, 0],
                                                "equal": True}
    assert math.isnan(out["history"][1]["mean_reward_1"])
    assert np.isfinite(out["final_fitness"]).all()
    assert all(torch.isfinite(p).all() for m in pop.members
               for p in m.net.parameters())


def test_the_population_decays_and_folds_every_member():
    pop, _ = _pop([])
    lr = pop.hparams.lr.copy()
    states = [(c.generator.get_state(), g.get_state())
              for c, g in zip(pop.carries, pop.generators)]
    pop.scale_lr(0.25)
    assert pop.hparams.lr.dtype == np.float32
    assert np.array_equal(pop.hparams.lr, (lr * 0.25).astype(np.float32))
    assert [float(h.lr) for h in pop.member_hp] == pop.hparams.lr.tolist()
    pop.fold_key(1)
    for (c0, g0), c, g in zip(states, pop.carries, pop.generators):
        assert not torch.equal(c0, c.generator.get_state())
        assert not torch.equal(g0, g.get_state())


def test_the_population_watchdog_needs_a_store():
    pop, _ = _pop([])
    with pytest.raises(ValueError, match="checkpoint store"):
        pop.run(1, watchdog=tres.DivergenceWatchdog())


# ---- corrupt checkpoints ----------------------------------------------------

@pytest.mark.parametrize("fix_checksums", [False, True])
def test_a_corrupted_step_falls_back_as_in_jax(tmp_path, jax_cli, torch_cli,
                                              fix_checksums, capsys):
    """Both packages' stores of the CLI runs hold steps 4, 6 and 8; each
    package corrupts its step 8 and falls back to step 6, the checksum
    pre-check catching it unless the sidecar was rewritten."""
    import orbax.checkpoint as ocp
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(jax_cli["dir"], jd)
    shutil.copytree(torch_cli["dir"], td)
    assert jres.corrupt_checkpoint(jd, 8, fix_checksums=fix_checksums) > 0
    assert tres.corrupt_checkpoint(td, 8, fix_checksums=fix_checksums) == 1
    jck = jckpt.Checkpointer(jd)
    jck._restore_candidates(None, True, lambda: ocp.args.Composite(
        state=ocp.args.StandardRestore(), meta=ocp.args.JsonRestore()))
    j_err = capsys.readouterr().err
    exp = Experiment.build(FAST, device="cpu")
    meta = exp.restore_checkpoint(Checkpointer(td))
    t_err = capsys.readouterr().err
    assert jck.last_restored_step == 6 and meta["iteration"] == 2
    assert exp.step == 6
    for err in (j_err, t_err):
        assert "checkpoint: step 8 failed to restore" in err
        assert "falling back to step 6" in err
        assert ("CheckpointChecksumError" in err) is not fix_checksums


def test_corrupting_a_missing_step_raises_as_in_jax(tmp_path):
    with pytest.raises(FileNotFoundError) as je:
        jres.corrupt_checkpoint(str(tmp_path), 123)
    with pytest.raises(FileNotFoundError) as te:
        tres.corrupt_checkpoint(str(tmp_path), 123)
    assert str(te.value) == str(je.value)


def test_every_step_corrupt_raises_restore_error(tmp_path, torch_cli):
    d = str(tmp_path / "t")
    shutil.copytree(torch_cli["dir"], d)
    for s in Checkpointer(d).all_steps():
        tres.corrupt_checkpoint(d, s)
    with pytest.raises(CheckpointRestoreError, match="failed to restore"):
        Experiment.build(FAST, device="cpu").restore_checkpoint(
            Checkpointer(d))


def test_a_fault_corrupts_the_saved_step_and_the_rollback_falls_back(
        tmp_path, capsys):
    """``corrupt-ckpt@2`` then ``nan-grad@3``: the rollback finds step 6
    truncated and restores step 4, so iterations 2 and 3 run again."""
    exp, out, restored = _watched(tmp_path / "ck",
                                  specs=("corrupt-ckpt@2", "nan-grad@3"))
    err = capsys.readouterr().err
    assert "fault-injection: corrupted checkpoint step 6 (1 files) after " \
        "iteration 2" in err
    assert "falling back to step 4" in err
    ev = out["rollback_events"][0]
    assert (ev["iteration"], ev["restored_step"], ev["resume_iteration"]) \
        == (3, 4, 2)
    assert [h["iteration"] for h in out["history"]] == [0, 1, 2, 2, 3]
    assert exp.iteration == 4 and restored[0][0] == 4


# ---- the train CLI ----------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--fault", "nonsense"], ["--fault", "nan-grad@1:rank=x"],
    ["--max-rollbacks", "2"], ["--fault", "corrupt-ckpt@1"],
    ["--max-rollbacks", "-1", "--ckpt-dir", "unused"],
    ["--async", "--max-rollbacks", "1", "--ckpt-dir", "unused"],
    ["--async", "--fault", "nan-grad@1"]],
    ids=["bad-spec", "bad-rank", "rollbacks-no-dir", "corrupt-no-dir",
         "negative-budget", "async-rollbacks", "async-fault"])
def test_the_cli_refuses_in_jaxs_words(extra):
    args = ["--config", "ppo-mlp-synth64", *CLI_FAST, *extra]
    with pytest.raises(SystemExit) as je:
        jtrain.main(args)
    with pytest.raises(SystemExit) as te:
        ttrain.main(args + ["--device", "cpu"])
    assert str(te.value.code) == str(je.value.code)


@pytest.mark.parametrize("kind", ["kill-rank", "lose-rank"])
def test_the_cli_refuses_multihost_faults(kind):
    args = ["--config", "ppo-mlp-synth64", *CLI_FAST,
            "--fault", f"{kind}@1:rank=0"]
    with pytest.raises(SystemExit) as je:
        jtrain.main(args)
    with pytest.raises(SystemExit) as te:
        ttrain.main(args + ["--device", "cpu"])
    head = "kill-rank/lose-rank are multihost faults and this CLI is one " \
        "process;"
    assert str(je.value.code).startswith(head)
    assert str(te.value.code).startswith(head)
    assert "item 21" in str(te.value.code)


def test_the_cli_still_refuses_the_mesh():
    with pytest.raises(SystemExit, match=r"--mesh .*item 21"):
        ttrain.main(["--config", "ppo-mlp-synth64", "--mesh", "auto",
                     "--device", "cpu"])


def test_the_cli_gives_up_cleanly(tmp_path):
    with pytest.raises(SystemExit) as e:
        ttrain.main(["--config", "ppo-mlp-synth64", *CLI_FAST,
                     "--ckpt-dir", str(tmp_path), "--max-rollbacks", "0",
                     "--fault", "nan-grad@1", "--device", "cpu"])
    assert str(e.value.code).startswith(
        "divergence watchdog gave up: diverged at iteration 1 "
        "(non-finite total_loss=nan) after 0 rollback(s)")


def test_the_cli_corrupts_then_resumes_from_the_step_before(tmp_path,
                                                           capsys):
    """JAX's ``test_corrupt_ckpt_fault_then_resume_falls_back``: the step
    saved after iteration 3 is truncated by the fault; the resumed run
    restores iteration 2's step and trains on."""
    args = ["--config", "ppo-mlp-synth64", *CLI_FAST, "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "1", "--device", "cpu"]
    ttrain.main(args + ["--fault", "corrupt-ckpt@3"])
    assert "fault-injection: corrupted checkpoint step 8" in \
        capsys.readouterr().err
    out = ttrain.main(args + ["--resume", "--iterations", "1"])
    err = capsys.readouterr().err
    assert "falling back to step 6" in err
    assert "resumed from step 6 (iteration 2" in err
    assert out["iterations"] == 1 and math.isfinite(out["env_steps_per_sec"])


def test_the_cli_hands_the_population_its_watchdog(tmp_path, capsys):
    out = ttrain.main(["--config", "ppo-mlp-synth64", *CLI_FAST, "--pbt",
                       "--n-pop", "2", "--pbt-ready", "1", "--ckpt-dir",
                       str(tmp_path), "--ckpt-every", "2",
                       "--max-rollbacks", "1", "--fault",
                       "nan-grad@1:rank=1", "--device", "cpu"])
    assert out["rollbacks"] == 0 and out["rollback_events"] == []
    assert np.isfinite(out["final_fitness"]).all()
    assert "fault-injection: nan-grad at iteration 1 member 1" in \
        capsys.readouterr().err
