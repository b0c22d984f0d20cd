"""The port's fused run, config 3's fairness table and the CLIs of this
slice, against the JAX package's where it has a counterpart.

- ``run_fused(k)`` is ``k`` iterations of ``run`` bit for bit (PPO and
  A2C): parameters, optimizer state, reward moments, carry, generators;
  ``run(fused_chunk=N)`` fires its hooks on JAX's grid, is the unchunked
  run bit for bit, and refuses an indivisible cadence with JAX's words.
- A2C with ``reward_norm``: ``k`` iterations, a save, a restore into a
  fresh experiment and ``k`` more equal ``2k`` bit for bit (JAX's
  checkpoint drops the reward moments; the port keeps them).
- ``fairness_report`` against JAX's on the same f32 weights and windows,
  tenant ids past ``n_tenants`` included: every row equal (the avg JCT
  within rtol 1e-12, a mean of the same f64 values pooled in the same
  order), and the same ``format_fairness`` text; ``jain_index`` equal.
- ``evaluate --fairness`` and ``train --config a2c-pai-fair`` in
  subprocesses; the new train flags land where JAX's land, and every
  refusal of this slice is JAX's word for word or names the item it
  waits for; ``bench --device cpu`` prints its JSON line.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu import eval as jeval
from rlgpuschedule_tpu import evaluate as jevaluate
from rlgpuschedule_tpu import train as jtrain
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu_torch import bench as tbench
from rlgpuschedule_tpu_torch import configs as tconfigs
from rlgpuschedule_tpu_torch import eval as teval
from rlgpuschedule_tpu_torch import evaluate as tevaluate
from rlgpuschedule_tpu_torch import train as ttrain
from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
from rlgpuschedule_tpu_torch.experiment import Experiment
from rlgpuschedule_tpu_torch.models import make_policy, params_from_jax
from torch_jax_builds import fast_jax_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tensors here are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

SMALL = dict(n_envs=2, n_nodes=4, gpus_per_node=4, window_jobs=12,
             queue_len=4, horizon=96)
FAIR_SMALL = dict(n_envs=3, n_nodes=4, gpus_per_node=8, window_jobs=16,
                  queue_len=4, horizon=128)
FAIR_FLAGS = ["--config", "a2c-pai-fair", "--n-envs", "3", "--n-nodes", "4",
              "--gpus-per-node", "8", "--window-jobs", "16", "--queue-len",
              "4", "--horizon", "128"]


def _cfg(algo="ppo", **kw):
    if algo == "ppo":
        base = tconfigs.CONFIGS["ppo-mlp-synth64"]
        return dataclasses.replace(
            base, **SMALL, **kw, ppo=dataclasses.replace(
                base.ppo, n_steps=8, n_epochs=2, n_minibatches=2))
    base = tconfigs.CONFIGS["a2c-pai-fair"]
    a2c = kw.pop("a2c", {})
    return dataclasses.replace(base, **SMALL, **kw,
                               a2c=dataclasses.replace(base.a2c, n_steps=8,
                                                       **a2c))


def _tensors(tree):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _assert_same_state(a: Experiment, b: Experiment):
    """Every tensor of two experiments' policy, optimizer, reward
    moments and carry, both generators, the step and the iteration,
    bit for bit."""
    pairs = [(a.net.state_dict(), b.net.state_dict()),
             (a.train_state.opt.state_dict()["state"],
              b.train_state.opt.state_dict()["state"]),
             (tuple(a.train_state.reward_stats or ()),
              tuple(b.train_state.reward_stats or ())),
             (tuple(a.carry.env_state.sim) + (a.carry.env_state.t,
                                              a.carry.obs, a.carry.mask),
              tuple(b.carry.env_state.sim) + (b.carry.env_state.t,
                                              b.carry.obs, b.carry.mask))]
    for x, y in pairs:
        xs, ys = list(_tensors(x)), list(_tensors(y))
        assert len(xs) == len(ys)
        for u, v in zip(xs, ys):
            assert u.dtype == v.dtype and torch.equal(u, v)
    assert torch.equal(a.carry.generator.get_state(),
                       b.carry.generator.get_state())
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.step == b.step and a.iteration == b.iteration
    assert a.window_cursor == b.window_cursor


# ---- run_fused and the chunked run -----------------------------------------

@pytest.mark.parametrize("algo,kw", [
    ("ppo", {}), ("a2c", {}), ("a2c", dict(a2c=dict(reward_norm=True))),
    ("ppo", dict(resample_every=0, drain_frac=0.5))],
    ids=["ppo", "a2c", "a2c-reward-norm", "ppo-drain"])
def test_run_fused_is_k_iterations_of_run(algo, kw):
    a = Experiment.build(_cfg(algo, **kw), device="cpu")
    b = Experiment.build(_cfg(algo, **kw), device="cpu")
    before = [p.detach().clone() for p in a.net.parameters()]
    metrics = a.run_fused(3)
    b.run(3)
    _assert_same_state(a, b)
    assert type(metrics).__name__ == ("PPOMetrics" if algo == "ppo"
                                      else "A2CMetrics")
    assert all(math.isfinite(float(v)) for v in metrics)
    assert any(not torch.equal(x, y.detach())
               for x, y in zip(before, a.net.parameters()))
    assert a.iteration == 3
    out = a.run(1)                  # the host loop goes on afterwards
    assert out["iterations"] == 1 and a.iteration == 4


def test_run_fused_chunked_hooks_fire_on_grid(tmp_path):
    """``tests/test_experiment.py``'s case, with the probe and the
    checkpoints: every hook at the chunk boundaries 3 and 7."""
    exp = Experiment.build(_cfg(), device="cpu")
    rows, probes = [], []
    with Checkpointer(str(tmp_path / "ck"), max_to_keep=5) as ck:
        out = exp.run(8, log_every=4, logger=lambda i, m: rows.append(i),
                      ckpt=ck, ckpt_every=4, eval_every=4,
                      eval_fn=lambda i: probes.append(i) or {"x": 1.0},
                      fused_chunk=4)
        steps = ck.all_steps()
    assert rows == [3, 7] and probes == [3, 7]
    assert [h["iteration"] for h in out["history"]] == [3, 7]
    assert steps == [4 * 4, 8 * 4]      # Adam steps: 4 per iteration
    assert out["iterations"] == 8 and exp.iteration == 8
    assert np.isfinite(out["env_steps_per_sec"])


def test_chunked_run_is_the_unchunked_run_bit_for_bit():
    cfg = _cfg(resample_every=4, drain_frac=0.5)
    a = Experiment.build(cfg, device="cpu")
    b = Experiment.build(cfg, device="cpu")
    la, lb = [], []
    a.run(8, log_every=4, logger=lambda i, m: la.append((i, m)),
          fused_chunk=4)
    b.run(8, log_every=1, logger=lambda i, m: lb.append((i, m)))
    _assert_same_state(a, b)
    assert a.window_cursor == 1 * cfg.n_envs
    assert la == [r for r in lb if r[0] in (3, 7)]


@pytest.mark.parametrize("kw", [dict(iterations=8, log_every=3),
                                dict(iterations=6)])
def test_chunked_run_refuses_an_indivisible_cadence_like_jax(kw):
    jcfg = dataclasses.replace(jconfigs.CONFIGS["ppo-mlp-synth64"], **SMALL)
    with pytest.raises(ValueError) as want:
        fast_jax_build(jcfg).run(fused_chunk=4, **kw)
    exp = Experiment.build(_cfg(), device="cpu")
    with pytest.raises(ValueError) as got:
        exp.run(fused_chunk=4, **kw)
    assert str(got.value) == str(want.value)
    assert exp.iteration == 0               # refused before any step
    exp.run(2)
    with pytest.raises(ValueError, match="starts from"):
        exp.run(4, fused_chunk=4)


def test_reward_norm_a2c_resume_is_the_uninterrupted_run(tmp_path):
    cfg = _cfg("a2c", a2c=dict(reward_norm=True))
    exp = Experiment.build(cfg, device="cpu")
    exp.run(3)
    with Checkpointer(str(tmp_path / "ck")) as ck:
        exp.save_checkpoint(ck)
        exp.run(3)
        fresh = Experiment.build(cfg, device="cpu")
        fresh.restore_checkpoint(ck)
        assert float(fresh.train_state.reward_stats.count) == \
            3 * exp.steps_per_iteration
    fresh.run(3)
    _assert_same_state(exp, fresh)
    assert float(exp.train_state.reward_stats.count) == \
        6 * exp.steps_per_iteration


# ---- the fairness table ------------------------------------------------------

@pytest.fixture(scope="module")
def fair_pair():
    """Config 3 cut to a small size in both packages, the policy in f32
    with the JAX init's weights on both sides."""
    cfg_j = dataclasses.replace(jconfigs.CONFIGS["a2c-pai-fair"],
                                **FAIR_SMALL)
    cfg_t = dataclasses.replace(tconfigs.CONFIGS["a2c-pai-fair"],
                                **FAIR_SMALL)
    exp_j = fast_jax_build(cfg_j)
    net32 = jmake_policy("flat", exp_j.env_params.n_actions,
                         dtype=jnp.float32)
    exp_j = dataclasses.replace(
        exp_j, apply_fn=lambda p, o, m: net32.apply(p, o, m))
    exp_t = Experiment.build(cfg_t, device="cpu")
    tp = exp_t.env_params
    net = make_policy("flat", tp.n_actions, tp.obs_shape(),
                      dtype=torch.float32, device="cpu")
    net.load_state_dict(params_from_jax(
        jax.device_get(exp_j.train_state.params)))
    exp_t.train_state = exp_t.train_state._replace(net=net)
    return exp_j, exp_t


def _assert_same_fairness(got, want):
    assert list(got) == list(want)
    for name in want:
        g, w = got[name], want[name]
        assert set(g) == set(w) == {"avg_jct", "jain", "completion",
                                    "tenant_avg_jct"}
        np.testing.assert_allclose(g["avg_jct"], w["avg_jct"], rtol=1e-12,
                                   err_msg=name)
        np.testing.assert_allclose(g["jain"], w["jain"], rtol=1e-12,
                                   err_msg=name)
        assert g["completion"] == w["completion"], name
        # NaN (a tenant with nothing completed) counts equal to NaN
        np.testing.assert_array_equal(g["tenant_avg_jct"],
                                      w["tenant_avg_jct"], err_msg=name)


def test_fairness_report_matches_jax(fair_pair):
    exp_j, exp_t = fair_pair
    want = jeval.fairness_report(exp_j, max_steps=128)
    got = teval.fairness_report(exp_t, max_steps=128)
    assert set(got) == {"policy", "fifo", "sjf", "srtf", "tiresias"}
    _assert_same_fairness(got, want)
    assert len(got["policy"]["tenant_avg_jct"]) == 8
    for row in got.values():
        assert 0 < row["jain"] <= 1.0 and 0 < row["completion"] <= 1.0
    assert teval.format_fairness(got) == jeval.format_fairness(want)
    # the baselines' tenant pooling averages to the plain table's rows
    plain = teval.baseline_jct_table(exp_t.windows, 4, 8, names=("fifo",))
    assert got["fifo"]["avg_jct"] == pytest.approx(plain["fifo"], rel=1e-6)


def test_fairness_report_pools_tenant_ids_beyond_the_config(fair_pair):
    """``tests/test_eval.py``'s case: ids 2-4 under ``n_tenants=2``
    still count, in both packages alike."""
    exp_j, exp_t = fair_pair
    exp_j = dataclasses.replace(exp_j, cfg=dataclasses.replace(
        exp_j.cfg, n_tenants=2))
    exp_t.cfg = dataclasses.replace(exp_t.cfg, n_tenants=2)
    windows = []
    for w in exp_t.windows:
        t = np.asarray(w.tenant).copy()
        t[w.valid] = 2 + (np.flatnonzero(w.valid) % 3)
        windows.append(dataclasses.replace(w, tenant=t))
    jwindows = [dataclasses.replace(jw, tenant=w.tenant)
                for jw, w in zip(exp_j.windows, windows)]
    want = jeval.fairness_report(exp_j, windows=jwindows, max_steps=128,
                                 baselines=("fifo", "sjf"))
    got = teval.fairness_report(exp_t, windows=windows, max_steps=128,
                                baselines=("fifo", "sjf"))
    exp_t.cfg = dataclasses.replace(exp_t.cfg, n_tenants=8)
    _assert_same_fairness(got, want)
    assert len(got["fifo"]["tenant_avg_jct"]) == 5
    assert got["fifo"]["completion"] == pytest.approx(1.0)


@pytest.mark.parametrize("xs", [[1.0, 1.0, 1.0], [3.0, 1.0], [5.0],
                                [2.0, np.nan, 0.0, 4.0], [np.nan], []])
def test_jain_index_matches_jax(xs):
    got, want = teval.jain_index(np.array(xs)), jeval.jain_index(
        np.array(xs))
    assert (math.isnan(got) and math.isnan(want)) or got == want


def test_format_fairness_sorts_a_nan_row_last():
    rep = {"a": {"avg_jct": float("nan"), "jain": float("nan"),
                 "completion": 0.0},
           "b": {"avg_jct": 3.0, "jain": 1.0, "completion": 1.0}}
    assert teval.format_fairness(rep) == jeval.format_fairness(rep)
    assert teval.format_fairness(rep).splitlines()[-1].startswith("a")


# ---- the CLIs -------------------------------------------------------------------

def _run(module, argv, timeout=600):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_evaluate_fairness_cli_in_a_subprocess(fair_pair):
    _, exp_t = fair_pair
    p = _run("rlgpuschedule_tpu_torch.evaluate",
             FAIR_FLAGS + ["--fairness", "--max-steps", "128",
                           "--device", "cpu"])
    assert p.returncode == 0, p.stderr
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert "Jain(tenant JCT)" in p.stderr
    assert line["device_name"] == "cpu"
    assert line["repro"]["config"] == "a2c-pai-fair"
    # the seeded init at bf16, as the CLI builds it, in this process
    want = teval.fairness_report(Experiment.build(exp_t.cfg, device="cpu"),
                                 max_steps=128)
    for name, row in want.items():
        assert line[name]["tenant_avg_jct"] == row["tenant_avg_jct"]
        assert line[name]["avg_jct"] == row["avg_jct"]


def test_train_cli_trains_config_three_in_a_subprocess(tmp_path):
    p = _run("rlgpuschedule_tpu_torch.train",
             FAIR_FLAGS + ["--iterations", "4", "--log-every", "2",
                           "--fused-chunk", "2", "--reward-norm",
                           "--ckpt-dir", str(tmp_path / "ck"),
                           "--ckpt-every", "2", "--device", "cpu"])
    assert p.returncode == 0, p.stderr
    lines = [json.loads(x) for x in p.stdout.splitlines()]
    rows, summary = lines[:-1], lines[-1]
    assert [r["iteration"] for r in rows] == [1, 3]
    for r in rows:
        assert set(r) == {"iteration", "total_loss", "pg_loss", "v_loss",
                          "entropy", "mean_reward", "mean_value"}
        assert all(math.isfinite(v) for v in r.values())
    assert summary["algo"] == "a2c" and summary["n_steps"] == 16
    assert summary["env_steps"] == 4 * 16 * 3
    ck = Checkpointer(str(tmp_path / "ck"))
    assert ck.all_steps() == [2, 4]      # one RMSprop update per iteration


@pytest.mark.parametrize("argv", [
    ["--config", "a2c-pai-fair", "--n-epochs", "2", "--n-minibatches", "4"],
    ["--config", "a2c-pai-fair", "--bf16-update", "--reward-norm",
     "--bf16-advantages", "--minibatch-size", "64"],
    ["--config", "ppo-mlp-synth64", "--minibatch-size", "64",
     "--bf16-update", "--correction", "none"],
    ["--config", "ppo-mlp-synth64", "--reward-norm", "--bf16-advantages",
     "--lr", "1e-3"],
    ["--config", "ppo-mlp-synth64"]])
def test_train_flags_land_where_jax_puts_them(argv):
    """``tests/test_cli.py``'s case: the algorithm flags go to the
    config's own algorithm, with JAX's values."""
    jcfg = jtrain.apply_overrides(jconfigs.CONFIGS[argv[1]],
                                  jtrain.build_parser().parse_args(argv))
    tcfg = ttrain.apply_overrides(tconfigs.CONFIGS[argv[1]],
                                  ttrain.build_parser().parse_args(argv))
    for algo in ("ppo", "a2c"):
        assert dataclasses.asdict(getattr(tcfg, algo)) == \
            dataclasses.asdict(getattr(jcfg, algo)), algo


def _exit_text(fn, argv):
    with pytest.raises(SystemExit) as e:
        fn(argv)
    return str(e.value.code)


@pytest.mark.parametrize("argv", [
    ["--config", "a2c-pai-fair", "--correction", "vtrace"],
    ["--config", "a2c-pai-fair", "--correction", "none"],
    ["--config", "ppo-mlp-synth64", "--correction", "vtrace"]])
def test_train_refusals_are_jaxs_word_for_word(argv):
    want = _exit_text(jtrain.main, argv)
    got = _exit_text(ttrain.main, argv + ["--device", "cpu"])
    assert got == want
    assert "--correction" in got


@pytest.mark.parametrize("argv,item", [
    (["--async"], 20), (["--mesh", "auto"], 21), (["--pbt", "--async"], 20),
    (["--continual", "x", "--fused-chunk", "2"], "fused_chunk"),
    (["--correction", "vtrace", "--async"], 20)])
def test_train_modes_still_refused_name_their_item(argv, item):
    text = _exit_text(ttrain.main, argv + ["--device", "cpu"])
    if isinstance(item, int):
        assert f"item {item})" in text
    else:
        # --continual is ported; with --fused-chunk it is the mode
        # table's refusal, JAX's word for word
        assert text == _exit_text(jtrain.main, argv)
        assert "--continual LOGDIR" in text and "--fused-chunk" in text


def test_train_refuses_an_indivisible_fused_chunk():
    text = _exit_text(ttrain.main, ["--config", "ppo-mlp-synth64",
                                    "--iterations", "3", "--fused-chunk",
                                    "2", "--device", "cpu"])
    assert text.startswith("fused_chunk=2 must divide")


FAIR_REFUSALS = [["--percentiles"], ["--eval-windows", "2"],
                 ["--backlog-gate", "2"], ["--no-stall-guard"]]


@pytest.mark.parametrize("extra", FAIR_REFUSALS,
                         ids=[a[0] for a in FAIR_REFUSALS])
def test_evaluate_fairness_refusals_are_jaxs_word_for_word(extra):
    argv = ["--config", "a2c-pai-fair", "--fairness"] + extra
    want = _exit_text(jevaluate.main, argv)
    got = _exit_text(tevaluate.main, argv + ["--device", "cpu"])
    assert got == want


def test_bench_prints_its_json_line_on_the_cpu():
    p = _run("rlgpuschedule_tpu_torch.bench", ["--device", "cpu"])
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["metric"] == "ppo_env_steps_per_sec_per_chip[cpu]"
    assert out["vs_baseline"] is None
    assert out["geometry"] == {"n_epochs": 2, "n_minibatches": 8,
                               "minibatch_size": 256}
    assert 7 <= out["repeats"] <= 15 and out["iters_per_repeat"] >= 3
    assert out["min"] <= out["value"] <= out["max"]
    assert out["value"] > 0 and out["device_name"] == "cpu"
    for k in ("spread", "spread_raw", "noisy", "power_limit", "method"):
        assert k in out


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "auto"], r"waits for .*item 21\)"),
    (["--async"], r"waits for .*item 20\)"),
    (["--staleness-bound", "4"], r"waits for .*item 20\)"),
    (["--correction", "vtrace"], "--correction vtrace × the synchronous")])
def test_bench_refuses_what_waits_for_a_slice(argv, match):
    with pytest.raises(SystemExit, match=match):
        tbench.main(argv + ["--device", "cpu"])


def test_bench_sweep_artifact_is_read_like_jax(tmp_path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(ROOT, "bench.py"))
    root_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_bench)
    art = tmp_path / "sweep.json"
    art.write_text(json.dumps({"sweep": "minibatch-geometry",
                               "best": {"n_epochs": 3, "n_minibatches": 2}}))
    assert tbench.geometry_from_sweep(str(art)) == \
        root_bench.geometry_from_sweep(str(art)) == (3, 2)
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    with pytest.raises(SystemExit) as want:
        root_bench.geometry_from_sweep(str(bad))
    with pytest.raises(SystemExit) as got:
        tbench.geometry_from_sweep(str(bad))
    assert str(got.value) == str(want.value)
    # and the flags beside it are refused
    with pytest.raises(SystemExit, match="--sweep supplies"):
        tbench.main(["--sweep", str(art), "--n-epochs", "4", "--device",
                     "cpu"])


def test_central_spread_matches_the_root_bench_rule():
    s = sorted([9.0, 10.0, 10.5, 11.0, 30.0, 1.0, 10.2])
    mid = s[1:6]
    assert tbench.central_spread(s) == (mid[-1] - mid[0]) / s[3]
