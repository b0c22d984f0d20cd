"""The port's ``profile_breakdown`` against the JAX package's, on the CPU.

- At ``--n-envs 2 --n-steps 8 --repeats 1`` the stage artifact holds
  every key of JAX's (and its stage, geometry and pipeline keys), plus
  each stage's device span and busy milliseconds and busy share (null
  off the card), and prices no
  MFU off the card: the one peak it knows is the H100 SXM's published
  dense bf16 figure, keyed on the card's name;
- the ``--sweep-minibatch`` artifact has JAX's keys and geometry grid,
  is ranked fastest first with ``best`` on top, and both packages'
  ``bench --sweep`` read its best geometry;
- ``--async`` and its two flags are refused naming item 20, and
  ``--sweep-out`` without ``--sweep-minibatch`` exits as JAX's does.
"""
import json

import pytest
import torch

import bench as jbench
from rlgpuschedule_tpu import profile_breakdown as jpb
from rlgpuschedule_tpu_torch import bench as tbench
from rlgpuschedule_tpu_torch import profile_breakdown as tpb

TINY = ["--n-envs", "2", "--n-steps", "8", "--repeats", "1",
        "--iters-per-repeat", "1"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_breakdown_artifact_has_jax_keys(capsys):
    want = jpb.main(TINY)
    got = tpb.main(TINY + ["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(got))
    assert set(want) <= set(got)
    for key in ("seconds_per_iteration", "stage_share_of_parts", "geometry",
                "advantage_pipeline"):
        assert set(got[key]) == set(want[key]), key
    assert got["geometry"] == want["geometry"]
    assert got["advantage_pipeline"] == want["advantage_pipeline"]
    assert (got["n_envs"], got["n_steps"], got["policy_params"]) == \
        (want["n_envs"], want["n_steps"], want["policy_params"]) == \
        (2, 8, 80394)
    sec = got["seconds_per_iteration"]
    assert all(v >= 0 for v in sec.values()) and sec["fused_loop"] > 0
    assert set(got["device_span_ms_per_iteration"]) == set(sec) - {
        "pipeline_overlap"}
    assert set(got["device_busy_ms_per_iteration"]) == \
        set(got["device_busy_share"]) == set(sec) - {
            "pipeline_overlap", "fused_step_blocked"}
    for key in ("device_span_ms_per_iteration",
                "device_busy_ms_per_iteration", "device_busy_share"):
        assert all(v is None for v in got[key].values()), key
    assert got["platform"] == "cpu" and got["device_kind"] is None
    assert got["mfu_total"] is None and got["mfu_update"] is None
    assert got["parts_over_fused_loop"] > 0


def test_the_peak_table_holds_the_h100_sxm_only():
    assert tpb.BF16_PEAK == {"NVIDIA H100 80GB HBM3": 989.4e12}


def test_sweep_artifact_is_ranked_and_read_by_both_benches(tmp_path,
                                                           capsys):
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    want = jpb.main(TINY + ["--sweep-minibatch", "--sweep-out", jpath])
    got = tpb.main(TINY + ["--device", "cpu", "--sweep-minibatch",
                           "--sweep-out", tpath])
    capsys.readouterr()
    assert set(want) <= set(got)
    assert {(r["n_epochs"], r["n_minibatches"]) for r in got["results"]} \
        == {(r["n_epochs"], r["n_minibatches"]) for r in want["results"]}
    assert set(got["results"][0]) >= set(want["results"][0])
    times = [r["update_s_per_iteration"] for r in got["results"]]
    assert times == sorted(times) and got["best"] == got["results"][0]
    default = next(r for r in got["results"]
                   if (r["n_epochs"], r["n_minibatches"]) == (2, 8))
    assert default["speedup_vs_default"] == pytest.approx(1.0)
    with open(tpath) as f:
        assert json.load(f)["best"] == got["best"]
    best = (got["best"]["n_epochs"], got["best"]["n_minibatches"])
    assert tbench.geometry_from_sweep(tpath) == best
    assert jbench.geometry_from_sweep(tpath) == best
    assert tbench.geometry_from_sweep(jpath) == (
        want["best"]["n_epochs"], want["best"]["n_minibatches"])


@pytest.mark.parametrize("argv", [["--async"], ["--staleness-bound", "2"],
                                  ["--async-out", "a.json"]])
def test_async_is_refused_naming_item_20(argv):
    with pytest.raises(SystemExit, match=r"item 20\)"):
        tpb.main(argv + ["--device", "cpu"])


def test_sweep_out_without_the_sweep_exits_as_jax_does():
    for main in (jpb.main, tpb.main):
        with pytest.raises(SystemExit) as e:
            main(["--sweep-out", "x.json"])
        assert e.value.code == 2
