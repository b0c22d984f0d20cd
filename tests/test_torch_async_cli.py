"""The async engine's CLI arms against the JAX package's, on the CPU at a
cut config 1 (2 x 4 GPUs, 16-job windows, 2 envs x 8 steps).

- ``train --async`` at bound 0 logs the sync CLI's rows exactly; bound 4
  with ``--correction vtrace`` checkpoints at its barriers with JAX's
  ``async_iteration``/``staleness_bound`` meta; ``--pbt --async`` trains
  the population; the async flags' refusals are JAX's word for word, and
  no flag of the train CLI waits for the async slice any more;
- ``bench --async``'s line has the root bench's ``bench_async`` keys
  (read from its source) plus the card's name and power limit, and
  ``profile_breakdown --async`` the keys of JAX's ``_profile_async``
  table (nested keys too) plus the card's; ``--async-out`` writes it.
"""
import argparse
import ast
import dataclasses
import json
import os

import pytest
import torch

from rlgpuschedule_tpu import train as jtrain
from rlgpuschedule_tpu_torch import bench as tbench
from rlgpuschedule_tpu_torch import profile_breakdown as tpb
from rlgpuschedule_tpu_torch import train as ttrain
from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
from rlgpuschedule_tpu_torch.configs import PPO_MLP_SYNTH64

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = ["--config", "ppo-mlp-synth64", "--n-envs", "2", "--n-nodes", "2",
       "--gpus-per-node", "4", "--window-jobs", "16", "--horizon", "64",
       "--queue-len", "4", "--n-steps", "8", "--n-epochs", "1",
       "--n-minibatches", "2", "--device", "cpu"]


def _rows(capsys) -> list[dict]:
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


def test_train_async_bound0_logs_the_sync_rows(capsys):
    argv = CUT + ["--iterations", "3", "--log-every", "1"]
    ttrain.main(argv)
    sync = _rows(capsys)
    out = ttrain.main(argv + ["--async", "--staleness-bound", "0"])
    got = _rows(capsys)
    assert got[:-1] == sync[:-1]
    assert out["async"]["staleness_max"] == 0
    assert out["async"]["shared_group"] is True
    assert set(out["phase_seconds"]) >= {"actor", "learner", "queue_wait"}


def test_train_async_deep_vtrace_checkpoints_at_barriers(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    out = ttrain.main(CUT + [
        "--async", "--staleness-bound", "4", "--queue-capacity", "4",
        "--correction", "vtrace", "--iterations", "4", "--log-every", "1",
        "--ckpt-dir", ck, "--ckpt-every", "2"])
    rows = _rows(capsys)[:-1]
    assert [r["iteration"] for r in rows] == [0, 1, 2, 3]
    assert all("rho_mean" in r for r in rows)
    with Checkpointer(ck) as c:
        metas = [c.read_meta(s) for s in c.all_steps()]
    assert [(m["iteration"], m["async_iteration"], m["staleness_bound"])
            for m in metas] == [(1, 1, 4), (3, 3, 4)]
    assert out["async"]["staleness_bound"] == 4


def test_train_pbt_async_trains_the_population(capsys):
    out = ttrain.main(CUT + ["--pbt", "--async", "--n-pop", "2",
                             "--pbt-ready", "2", "--iterations", "2",
                             "--log-every", "1", "--staleness-bound", "0"])
    assert out["pbt_events"] == 1 and out["n_pop"] == 2
    assert out["async"]["staleness_max_per_member"] == [0, 0]
    assert "total_loss_mean" in _rows(capsys)[0]


def _exit_text(fn, argv):
    with pytest.raises(SystemExit) as e:
        fn(argv)
    return str(e.value.code)


@pytest.mark.parametrize("argv", [
    ["--actor-devices", "1"], ["--learner-devices", "0"],
    ["--staleness-bound", "0"], ["--queue-capacity", "3"],
    ["--async", "--staleness-bound", "-1"],
    ["--async", "--queue-capacity", "0"],
    ["--async", "--fused-chunk", "2"],
    ["--async", "--continual", "logs"]], ids=str)
def test_train_async_refusals_are_jaxs_word_for_word(argv):
    assert _exit_text(ttrain.main, argv + ["--device", "cpu"]) == \
        _exit_text(jtrain.main, argv)


def test_no_train_flag_waits_for_the_async_slice():
    assert not {"--async", "--actor-devices", "--learner-devices",
                "--staleness-bound", "--queue-capacity"} & set(
        ttrain.UNPORTED_FLAGS)
    assert "--async" not in tbench.UNPORTED_FLAGS


def _jax_keys(path: str, func: str) -> dict:
    """The keys of the dict literal ``func`` prints (``json.dumps``) or
    returns in the JAX file ``path``, nested dict literals as dicts."""
    tree = ast.parse(open(os.path.join(ROOT, path), encoding="utf-8").read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)

    def keys(d: ast.Dict) -> dict:
        return {k.value: (keys(v) if isinstance(v, ast.Dict) else None)
                for k, v in zip(d.keys, d.values)}

    found = [n for n in ast.walk(fn) if isinstance(n, ast.Dict)
             and any(isinstance(k, ast.Constant) and k.value in
                     ("metric", "profile") for k in n.keys)]
    return keys(found[0])


def assert_keys(got: dict, want: dict) -> None:
    """``got`` has ``want``'s keys, and those of each nested literal."""
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert_keys(got[k], v)


def test_bench_async_line_has_the_root_benchs_keys(capsys):
    # 3 calls of one iteration: the line's keys, not a rate, are checked
    cfg = dataclasses.replace(
        PPO_MLP_SYNTH64, n_envs=2, n_nodes=2, gpus_per_node=4,
        window_jobs=16, horizon=64, queue_len=4,
        ppo=dataclasses.replace(PPO_MLP_SYNTH64.ppo, n_steps=8, n_epochs=1,
                                n_minibatches=2))
    line = tbench.bench_async(
        cfg, argparse.Namespace(correction="vtrace", staleness_bound=2,
                                repeats=3),
        torch.device("cpu"), 1)
    assert line["iters_per_repeat"] == 1 and line["repeats"] == 3
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == line
    want = _jax_keys("bench.py", "bench_async")
    assert_keys(line, {**want, "device_name": None, "power_limit": None})
    assert line["metric"] == "async_actor_learner_speedup[cpu]"
    assert line["staleness_bound"] == 2 and line["correction"] == "vtrace"
    assert line["speedup"] > 0 and line["projected_overlap_speedup"] >= 1
    assert 0 < line["async_overlap_measured"] <= 1


@pytest.mark.parametrize("argv, message", [
    (["--repeats", "3"], "--repeats applies with --async"),
    (["--async", "--repeats", "0"], "--repeats must be >= 1"),
])
def test_bench_repeats_belongs_to_async(argv, message):
    with pytest.raises(SystemExit, match=message):
        tbench.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("flags, devices", [
    ([], [torch.device("cpu")]),
    (["--actor-devices", "1", "--learner-devices", "1"],
     torch.device("cpu")),
])
def test_train_async_shares_its_device_unless_groups_are_asked_for(
        monkeypatch, capsys, flags, devices):
    # the default is the shared group on --device: the split of the
    # visible devices (unverified for one card each) runs only when the
    # group flags ask for it
    seen = []
    real = ttrain.split_devices

    def spy(**kw):
        seen.append(kw)
        return real(**kw)

    monkeypatch.setattr(ttrain, "split_devices", spy)
    out = ttrain.main(CUT + ["--iterations", "1", "--async", *flags])
    (kw,) = seen
    assert kw["devices"] == devices
    assert out["async"]["shared_group"] is True


def test_profile_breakdown_async_table_has_jaxs_keys(tmp_path):
    path = str(tmp_path / "async.json")
    out = tpb.main(["--device", "cpu", "--n-envs", "2", "--n-steps", "8",
                    "--repeats", "1", "--iters-per-repeat", "2",
                    "--async", "--staleness-bound", "1",
                    "--async-out", path])
    want = _jax_keys("rlgpuschedule_tpu/profile_breakdown.py",
                     "_profile_async")
    assert_keys(out, {**want, "device_kind": None, "power_limit": None})
    with open(path) as f:
        assert json.load(f) == out
    assert out["profile"] == "async-phase-table"
    assert out["platform"] == "cpu" and out["iters_per_repeat"] == 2
    assert set(out["async_phase_seconds_per_iteration"]) >= {
        "actor", "learner", "queue_wait"}
    assert out["staleness"]["max"] <= 1
