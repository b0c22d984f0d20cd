"""The observability flags of the port's train and evaluate CLIs, on the
CPU at ``tests/test_cli.py``'s ``FAST`` sizes.

- ``train --obs-dir --alarms --trace-spans --log-csv --tb-dir``: the
  timeline, the CSV and the TensorBoard file, read by both packages'
  ``obs.report --strict-alarms`` (exit 0 from each);
- ``--resume`` appends to the CSV under the original header;
- a PBT population's run: ``pbt_exploit`` events and the flattened
  per-member and ``{metric}_mean`` columns on each iteration event;
- ``evaluate --matrix --obs-dir --alarms`` and ``--chaos --obs-dir
  --trace-spans``: both reports exit 0 with the same alarm summary;
- ``--profile-dir`` and ``--debug-nans`` on a clean run;
- every refusal of the new flags is the JAX CLI's word for word, and
  ``--debug-nans`` with ``--alarms`` (which JAX takes) is refused with
  the port's reason.
"""
import csv
import os

import pytest
import torch

from rlgpuschedule_tpu import evaluate as jevaluate
from rlgpuschedule_tpu import train as jtrain
from rlgpuschedule_tpu.obs import report as jreport
from rlgpuschedule_tpu_torch import evaluate as tevaluate
from rlgpuschedule_tpu_torch import train as ttrain
from rlgpuschedule_tpu_torch.obs import merge_dir
from rlgpuschedule_tpu_torch.obs import report as treport

CLUSTER = ["--n-envs", "4", "--n-nodes", "2", "--gpus-per-node", "4",
           "--window-jobs", "16", "--horizon", "64", "--queue-len", "4"]
FAST = ["--config", "ppo-mlp-synth64", "--iterations", "2", *CLUSTER,
        "--log-every", "1", "--n-steps", "8", "--n-epochs", "1",
        "--n-minibatches", "2", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _strict(obs_dir, capsys):
    """Both reports' ``--strict-alarms`` exit codes and alarm lines."""
    out = {}
    for name, module in (("jax", jreport), ("torch", treport)):
        rc = module.main([obs_dir, "--strict-alarms"])
        out[name] = (rc, [x for x in capsys.readouterr().out.splitlines()
                          if x.startswith("alarms:")])
    assert out["torch"] == out["jax"]
    return out["torch"][0]


def _kinds(obs_dir):
    return [e["kind"] for e in merge_dir(obs_dir)]


def test_train_obs_run_reads_clean_in_both_reports(tmp_path, capsys):
    obs, tb = str(tmp_path / "obs"), str(tmp_path / "tb")
    log = str(tmp_path / "m.csv")
    out = ttrain.main(FAST + ["--obs-dir", obs, "--alarms", "--trace-spans",
                              "--log-csv", log, "--tb-dir", tb])
    assert out["iterations"] == 2
    kinds = _kinds(obs)
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert kinds.count("iteration") == 2 and "span_begin" in kinds
    assert not {"compile", "recompile", "transfer"} & set(kinds)
    assert _strict(obs, capsys) == 0
    rows = list(csv.DictReader(open(log)))
    assert [r["iteration"] for r in rows] == ["0", "1"]
    logged = [e["metrics"] for e in merge_dir(obs)
              if e["kind"] == "iteration"]
    assert [float(r["total_loss"]) for r in rows] == \
        [m["total_loss"] for m in logged]
    (tb_file,) = os.listdir(tb)
    assert tb_file.startswith("events.out.tfevents.")
    assert os.path.getsize(os.path.join(tb, tb_file)) > 100
    prom = open(os.path.join(obs, "metrics.prom")).read()
    assert "rlsched_iterations_total 2" in prom
    assert "rlsched_env_steps_total 64" in prom


def test_resume_appends_to_the_csv(tmp_path):
    log, ck = str(tmp_path / "m.csv"), str(tmp_path / "ck")
    obs = str(tmp_path / "obs")
    run = FAST + ["--log-csv", log, "--ckpt-dir", ck, "--ckpt-every", "1",
                  "--obs-dir", obs]
    ttrain.main(run)
    header = open(log).readline()
    ttrain.main(run + ["--resume"])
    lines = open(log).read().splitlines()
    assert lines[0] + "\n" == header and lines.count(lines[0]) == 1
    assert [r["iteration"] for r in csv.DictReader(open(log))] == \
        ["0", "1", "2", "3"]
    kinds = _kinds(obs)
    assert kinds.count("run_start") == 2 and "ckpt_restore" in kinds
    assert kinds.count("ckpt_save") == 4


def test_population_run_emits_pbt_exploit_events(tmp_path):
    obs = str(tmp_path / "obs")
    out = ttrain.main(["--config", "hier-pbt-member", "--device", "cpu",
                       "--pbt", "--n-pop", "2", "--pbt-ready", "1",
                       "--n-steps", "8", "--n-epochs", "1",
                       "--n-minibatches", "2", "--iterations", "3",
                       "--log-every", "1", "--obs-dir", obs, "--alarms",
                       "--trace-spans"])
    events = merge_dir(obs)
    exploits = [e for e in events if e["kind"] == "pbt_exploit"]
    assert len(exploits) == out["pbt_events"] >= 1
    for e in exploits:
        assert len(e["src"]) == 2 and 0 <= e["exploited"] <= 2
    start = next(e for e in events if e["kind"] == "run_start")
    assert start["loop"] == "population" and start["n_pop"] == 2
    iters = [e for e in events if e["kind"] == "iteration"]
    assert [e["iteration"] for e in iters] == [0, 1, 2]
    for e in iters:
        assert {"total_loss_0", "total_loss_1", "total_loss_mean",
                "mean_reward_mean"} <= set(e["metrics"])
        assert "step" in e["phases"] and "sync" in e["phases"]
    end = next(e for e in events if e["kind"] == "run_end")
    assert end["pbt_events"] == out["pbt_events"]
    assert not {"recompile", "transfer"} & {e["kind"] for e in events}


EVAL = ["--config", "ppo-mlp-synth64", "--n-envs", "2", "--n-nodes", "2",
        "--gpus-per-node", "4", "--window-jobs", "16", "--horizon", "64",
        "--queue-len", "4", "--device", "cpu"]


def test_evaluate_matrix_alarms_and_chaos_spans(tmp_path, capsys):
    mdir, cdir = str(tmp_path / "matrix"), str(tmp_path / "chaos")
    rep = tevaluate.main(EVAL + ["--matrix", "--matrix-regimes", "mixed",
                                 "--obs-dir", mdir, "--alarms"])
    assert rep["jobs_lost"] == 0
    assert "domain_cell" in _kinds(mdir)
    assert not {"compile", "recompile", "transfer"} & set(_kinds(mdir))
    rep = tevaluate.main(EVAL + ["--chaos", "--chaos-regimes", "storm",
                                 "--obs-dir", cdir, "--trace-spans"])
    assert rep["jobs_lost"] == 0
    kinds = _kinds(cdir)
    assert "env_fault" in kinds and "span_begin" in kinds
    capsys.readouterr()
    assert _strict(mdir, capsys) == 0
    assert _strict(cdir, capsys) == 0
    for d in (mdir, cdir):
        assert os.path.exists(os.path.join(d, "metrics.prom"))


def test_profile_dir_and_debug_nans_on_a_clean_run(tmp_path):
    prof = str(tmp_path / "prof")
    ttrain.main(FAST + ["--profile-dir", prof, "--debug-nans"])
    (trace,) = os.listdir(prof)
    assert trace.endswith(".pt.trace.json")
    assert os.path.getsize(os.path.join(prof, trace)) > 1000


TRAIN_REFUSALS = [
    ["--alarms"],
    ["--trace-spans"],
    ["--alarm-slow-iter", "1.0"],
    ["--obs-dir", "OBS", "--alarms", "--alarm-slow-iter", "0"],
]
EVAL_REFUSALS = [
    ["--obs-dir", "OBS"],
    ["--chaos", "--trace-spans"],
    ["--obs-dir", "OBS", "--matrix", "--trace-spans"],
    ["--alarms"],
    ["--matrix", "--alarms"],
]


def _exit_message(main, argv):
    with pytest.raises(SystemExit) as e:
        main(argv)
    return str(e.value.code)


@pytest.mark.parametrize("argv", TRAIN_REFUSALS, ids=" ".join)
def test_train_refusals_are_jax_word_for_word(argv, tmp_path):
    argv = [str(tmp_path) if a == "OBS" else a for a in argv]
    base = ["--config", "ppo-mlp-synth64"]
    want = _exit_message(jtrain.main, base + argv)
    got = _exit_message(ttrain.main, base + argv + ["--device", "cpu"])
    assert got == want and got.startswith("--")


@pytest.mark.parametrize("argv", EVAL_REFUSALS, ids=" ".join)
def test_evaluate_refusals_are_jax_word_for_word(argv, tmp_path):
    argv = [str(tmp_path) if a == "OBS" else a for a in argv]
    base = ["--config", "ppo-mlp-synth64"]
    want = _exit_message(jevaluate.main, base + argv)
    got = _exit_message(tevaluate.main, base + argv + ["--device", "cpu"])
    assert got == want and got.startswith("--")


def test_debug_nans_with_alarms_is_refused_with_the_reason(tmp_path):
    msg = _exit_message(ttrain.main, FAST + [
        "--debug-nans", "--alarms", "--obs-dir", str(tmp_path)])
    assert msg == ttrain.DEBUG_NANS_WITH_ALARMS
    assert "sync" in msg and not os.listdir(tmp_path)
