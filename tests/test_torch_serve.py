"""The port's serving surface: batching helpers, the bucketed engine
against the JAX engine, the CLI, and the no-fallback contract of the
entry points."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu.experiment import build_env_params as jbuild
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu.serve import batching as jbatching
from rlgpuschedule_tpu.serve.engine import InferenceEngine as JEngine
from rlgpuschedule_tpu_torch import configs as tconfigs
from rlgpuschedule_tpu_torch.decision import policy_decision
from rlgpuschedule_tpu_torch.env import env as tenv
from rlgpuschedule_tpu_torch.experiment import build_env_params as tbuild
from rlgpuschedule_tpu_torch.models import make_policy, params_from_jax
from rlgpuschedule_tpu_torch.analysis.sentinels import (
    CompileCounter, RecompileSentinelError, assert_no_recompiles,
    no_implicit_transfers)
from rlgpuschedule_tpu_torch.obs import Registry, read_events
from rlgpuschedule_tpu_torch.serve import InferenceEngine
from rlgpuschedule_tpu_torch.serve import __main__ as serve_cli
from rlgpuschedule_tpu_torch.serve.batching import next_bucket, pad_batch
from rlgpuschedule_tpu_torch.serve.fleet import fleet_replay, fleet_windows

# the tensors here are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_nodes=9, gpus_per_node=4, window_jobs=32, queue_len=4,
             horizon=128)


@pytest.fixture(scope="module")
def world():
    """A config-2-shaped (grid/CNN) JAX policy, its converted f32 twin,
    and a request pool: the (obs, mask) rows the greedy policy reaches in
    the first steps of four clusters (what the JAX package's
    ``build_request_pool`` collects, stepped here with the port's env)."""
    cfg = dataclasses.replace(tconfigs.CONFIGS["ppo-cnn-philly512"], **SMALL)
    env_params = jbuild(dataclasses.replace(
        jconfigs.CONFIGS["ppo-cnn-philly512"], **SMALL))
    tparams = tbuild(cfg)
    _, traces = fleet_windows(cfg, 4, device="cpu")
    net = jmake_policy("grid", env_params.n_actions, dtype=jnp.float32)
    obs_shape = env_params.obs_shape()
    params = jax.jit(net.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1,) + obs_shape),
                               jnp.ones((1, env_params.n_actions), bool))
    apply_fn = lambda p, o, m: net.apply(p, o, m)
    policy = make_policy("grid", env_params.n_actions, obs_shape,
                         dtype=torch.float32, device="cpu")
    policy.load_state_dict(params_from_jax(jax.device_get(params)))
    obs, mask = [], []
    with torch.no_grad():
        state, ts = tenv.reset(tparams, traces)
        for _ in range(4):
            obs.append(ts.obs.numpy())
            mask.append(ts.action_mask.numpy())
            a = policy_decision(policy, ts.obs, ts.action_mask)
            state, ts = tenv.vec_step(tparams, state, traces, a)
    return (apply_fn, params, env_params, np.concatenate(obs),
            np.concatenate(mask), policy)


@pytest.mark.parametrize("n,cap", [(1, 8), (5, 8), (8, 8), (9, 16),
                                   (200, 256)])
def test_next_bucket_matches_jax(n, cap):
    assert next_bucket(n, cap) == jbatching.next_bucket(n, cap)


@pytest.mark.parametrize("bad", [(0, 8), (9, 8), (3, 6)])
def test_next_bucket_refuses_like_jax(bad):
    with pytest.raises(ValueError):
        jbatching.next_bucket(*bad)
    with pytest.raises(ValueError):
        next_bucket(*bad)


def test_pad_batch_matches_jax():
    rng = np.random.default_rng(0)
    obs = rng.random((3, 5, 2), dtype=np.float32)
    mask = rng.random((3, 6)) < 0.5
    for x, fill in ((obs, False), (mask, True), (mask, False)):
        got = pad_batch(x, 8, fill_mask_true=fill)
        want = jbatching.pad_batch(x, 8, fill_mask_true=fill)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert pad_batch(obs, 3) is obs


def test_engine_matches_the_jax_engine_within_one_bucket(world):
    apply_fn, params, env_params, obs, mask, policy = world
    jeng = JEngine(apply_fn, params, env_params, max_bucket=16)
    teng = InferenceEngine(policy, max_bucket=16, device="cpu")
    assert obs.shape[0] >= 16
    for n in (9, 12, 16):                 # three sizes in bucket 16
        rows = np.arange(n) * 3 % obs.shape[0]
        ja, jb = jeng.decide(obs[rows], mask[rows])
        ta, tb = teng.decide(obs[rows], mask[rows])
        assert jb == tb == 16
        assert ta.dtype == np.asarray(ja).dtype == np.int32
        np.testing.assert_array_equal(np.asarray(ja), ta)
        # served actions are the replay rule's on the same observations
        with torch.no_grad():
            want = policy_decision(policy, torch.from_numpy(obs[rows]),
                                   torch.from_numpy(mask[rows]))
        np.testing.assert_array_equal(ta, want.numpy())


def test_padding_rows_do_not_change_the_real_rows(world):
    *_, obs, mask, policy = world
    eng = InferenceEngine(policy, max_bucket=32, device="cpu")
    alone = np.concatenate([eng.decide(obs[i:i + 1], mask[i:i + 1])[0]
                            for i in range(5)])
    batched, bucket = eng.decide(obs[:5], mask[:5])
    assert bucket == 8
    np.testing.assert_array_equal(alone, batched)


def test_engine_warmup_and_param_swap(world):
    *_, obs, mask, policy = world
    eng = InferenceEngine(policy, max_bucket=8, device="cpu")
    assert eng.warmup(obs[0], mask[0]) == (1, 2, 4, 8)
    assert eng.warmed_buckets == (1, 2, 4, 8)
    assert eng.warmup(obs[0], mask[0], buckets=(4,)) == ()
    with pytest.raises(ValueError, match="power of two"):
        eng.warmup(obs[0], mask[0], buckets=(3,))
    sd = {k: v.clone() for k, v in policy.state_dict().items()}
    before, _ = eng.decide(obs[:8], mask[:8])
    swapped = {k: (-v if k == "policy.weight" else v) for k, v in sd.items()}
    eng.set_params(swapped)
    after, _ = eng.decide(obs[:8], mask[:8])
    eng.set_params(sd)
    again, _ = eng.decide(obs[:8], mask[:8])
    np.testing.assert_array_equal(before, again)
    # negated policy weights turn argmax into argmin wherever a row has a
    # choice, so the swap must show
    multi = mask[:8].sum(1) > 1
    assert multi.any() and (before[multi] != after[multi]).all()
    bad = dict(sd, **{"policy.bias": torch.zeros(3)})
    with pytest.raises(ValueError, match="policy.bias"):
        eng.set_params(bad)
    with pytest.raises(ValueError, match="names"):
        eng.set_params({k: v for k, v in sd.items() if k != "value.bias"})


def test_engine_serves_cuda_by_default_and_refuses_without_it(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(world[-1])


def _run(args, cwd=ROOT, timeout=240):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_serve_cli_prints_a_fleet_report_on_cpu():
    p = _run(["-m", "rlgpuschedule_tpu_torch.serve", "--config",
              "ppo-mlp-synth64", "--fleet", "2", "--max-steps", "16",
              "--device", "cpu"])
    assert p.returncode == 0, p.stderr
    report = json.loads(p.stdout.strip().splitlines()[-1])
    fl = report["fleet"]
    assert report["config"] == "ppo-mlp-synth64"
    assert fl["n_clusters"] == 2 and fl["device"] == "cpu"
    assert fl["decisions"] == sum(fl["per_cluster"]["steps"]) <= 32
    assert len(fl["per_cluster"]["avg_jct"]) == 2
    assert 0.0 <= fl["completion"] <= 1.0


def test_serve_cli_serves_jax_weights_from_npz(tmp_path):
    """A Flax parameter tree saved flat as .npz is served without JAX:
    the CLI's fleet table equals an in-process replay with the same
    converted weights."""
    cfg = tconfigs.CONFIGS["ppo-mlp-synth64"]
    tparams = tbuild(cfg)
    net = jmake_policy("flat", tparams.n_actions)
    params = jax.device_get(jax.jit(net.init)(
        jax.random.PRNGKey(5), jnp.zeros((1,) + tparams.obs_shape()),
        jnp.ones((1, tparams.n_actions), bool)))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "w.npz", **flat)
    p = _run(["-m", "rlgpuschedule_tpu_torch.serve", "--fleet", "2",
              "--max-steps", "24", "--device", "cpu", "--weights",
              str(tmp_path / "w.npz")])
    assert p.returncode == 0, p.stderr
    got = json.loads(p.stdout.strip().splitlines()[-1])["fleet"]
    policy = make_policy("flat", tparams.n_actions, tparams.obs_shape(),
                         device="cpu")
    policy.load_state_dict(params_from_jax(params))
    _, traces = fleet_windows(cfg, 2, device="cpu")
    want = fleet_replay(policy, tparams, traces, max_steps=24, device="cpu")
    assert got["per_cluster"] == want["per_cluster"]


def test_serve_cli_refuses_what_the_slice_lacks():
    """The fault-regime fleet replay runs in a subprocess as a user meets
    it. The hierarchical preset's ``--bench`` runs through one engine,
    and ``--engines 2`` of it exits with the mode table's refusal in
    JAX's words (the router flags themselves are served:
    ``tests/test_torch_router.py``; the flywheel's flags:
    ``tests/test_torch_flywheel_cli.py``)."""
    # the fault-regime fleet replay came with the chaos slice: it runs
    p = _run(["-m", "rlgpuschedule_tpu_torch.serve", "--config",
              "ppo-mlp-synth64", "--fleet", "2", "--device", "cpu",
              "--fleet-regime", "storm", "--max-steps", "16"])
    assert p.returncode == 0, p.stderr
    fleet = json.loads(p.stdout.strip().splitlines()[-1])["fleet"]
    assert fleet["regime"] == "storm" and fleet["fleet_seed"] == 0
    p = _run(["-m", "rlgpuschedule_tpu_torch.serve", "--config",
              "hier-pbt-member", "--bench", "--n-envs", "2", "--pool-steps",
              "1", "--rounds", "3", "--device", "cpu"])
    assert p.returncode == 0, p.stderr
    bench = json.loads(p.stdout.strip().splitlines()[-1])["bench"]
    assert bench["requests"] > 0 and bench["post_warmup_recompiles"] == 0
    p = _run(["-m", "rlgpuschedule_tpu_torch.serve", "--config",
              "hier-pbt-member", "--bench", "--engines", "2", "--device",
              "cpu"])
    with pytest.raises(jconfigs.ModeCombinationError) as want:
        jconfigs.validate_mode_combination({"router": True, "hier": True})
    assert p.returncode != 0 and str(want.value) in p.stderr


def test_serve_cli_runs_the_front_door_around_a_soak(tmp_path):
    """``serve --soak 1 --frontend-port 0 --obs-dir D --trace-spans``: the
    self-check's decide answers 200, the drain refuses a late submit with
    the typed error and new connections; the post-mortem then rebuilds
    the self-check request's timeline from D, and the run is clean."""
    d = str(tmp_path / "obs")
    p = _run(["-m", "rlgpuschedule_tpu_torch.serve", "--config",
              "ppo-mlp-synth64", "--soak", "1", "--frontend-port", "0",
              "--device", "cpu", "--obs-dir", d, "--trace-spans"])
    assert p.returncode == 0, p.stderr
    rep = json.loads(p.stdout.strip().splitlines()[-1])
    fe = rep["frontend"]
    assert (fe["decide_status"], fe["decide_has_action"], fe["late_submit"],
            fe["post_drain_connect"]) == (200, True, "server-closed",
                                          "refused")
    assert rep["soak"]["requests"] == rep["soak"]["served"] + \
        rep["soak"]["shed"]
    p = _run(["-m", "rlgpuschedule_tpu_torch.obs.report", d, "--request",
              str(fe["request_id"]), "--json"])
    assert p.returncode == 0, p.stderr
    stages = [s["stage"] for s in json.loads(p.stdout)["stages"]]
    assert stages == ["enqueue", "served"]
    p = _run(["-m", "rlgpuschedule_tpu_torch.obs.report", d,
              "--strict-alarms"])
    assert p.returncode == 0, p.stdout + p.stderr


def test_serve_cli_runs_the_wire_arms_of_the_host_path():
    """``serve --host-path --wire-requests 64``: both socket arms serve
    every request, beside the in-process arms (the arena's allocations
    0); the flags' silent no-ops are refused."""
    p = _run(["-m", "rlgpuschedule_tpu_torch.serve", "--config",
              "ppo-mlp-synth64", "--host-path", "--wire-requests", "64",
              "--host-rounds", "20", "--device", "cpu"])
    assert p.returncode == 0, p.stderr
    hp = json.loads(p.stdout.strip().splitlines()[-1])["host_path"]
    legacy, arena = hp["arms"]
    assert arena["alloc_calls"] == 0 and arena["conservation_ok"]
    http, framed = hp["wire_arms"]
    assert (http["data_plane"], framed["data_plane"]) == ("legacy", "arena")
    for arm in (http, framed):
        assert arm["conservation_ok"] and arm["served"] == 64
        assert arm["decisions_per_s"] > 0
    assert hp["speedup"] == framed["decisions_per_s"] / \
        http["decisions_per_s"]
    for argv in (["--bench", "--wire-requests", "8"],
                 ["--bench", "--frontend-port", "0"],
                 ["--host-path", "--wire-requests", "-1"],
                 ["--soak", "1", "--frontend-port", "-1"],
                 ["--config", "hier-pbt-member", "--soak", "1",
                  "--frontend-port", "0"]):
        with pytest.raises(SystemExit) as e:
            serve_cli.main(argv + ["--device", "cpu"])
        assert e.value.code and "--" in str(e.value.code)


@pytest.mark.parametrize("name", ["gnn-gang-place", "ppo-mlp-preempt"])
def test_serve_cli_serves_the_new_presets_on_the_cpu(name):
    """``serve --fleet 2`` of each new preset: the report equals a
    library ``fleet_replay`` of the same seeded policy (the preemptive
    one with the stall guard on)."""
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.experiment import (build_env_params,
                                                    build_policy)
    p = _run(["-m", "rlgpuschedule_tpu_torch.serve", "--config", name,
              "--fleet", "2", "--max-steps", "48", "--device", "cpu"])
    assert p.returncode == 0, p.stderr
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["config"] == name
    cfg = CONFIGS[name]
    tp = build_env_params(cfg)
    _, traces = fleet_windows(cfg, 2, device="cpu")
    want = fleet_replay(build_policy(cfg, tp, device="cpu"), tp, traces,
                        max_steps=48, device="cpu")
    assert got["fleet"]["per_cluster"] == want["per_cluster"]


def test_chip_smoke_fails_without_a_gpu_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _run([os.path.join(ROOT, "chip_smoke.py")])
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    # a directory with chip_smoke.py and nothing else of the repo
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(ROOT, "chip_smoke.py"), "rb").read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


# ---- the engine's programs and sentinels ------------------------------


def test_engine_builds_once_per_bucket_across_request_sizes(world):
    *_, obs, mask, policy = world
    registry = Registry()
    eng = InferenceEngine(policy, max_bucket=8, device="cpu",
                          registry=registry)
    assert eng.graphs is False and eng.devices == (torch.device("cpu"),)
    with CompileCounter() as c:
        eng.warmup(obs[0], mask[0], buckets=(8,))
    assert (c.builds, c.captures) == (1, 0)
    with assert_no_recompiles("warmed serve bucket"):
        for n in (5, 6, 7, 8, 5):
            got, b = eng.decide(obs[:n], mask[:n])
            assert b == 8 and got.shape == (n,)
    assert eng.post_warmup_recompiles == 0
    assert registry.counter("serve_bucket_compiles_total").value == 1


def test_engine_blesses_a_new_bucket(world):
    *_, obs, mask, policy = world
    eng = InferenceEngine(policy, max_bucket=8, device="cpu")
    eng.warmup(obs[0], mask[0], buckets=(2,))
    with CompileCounter() as c:
        eng.decide(obs[:4], mask[:4])              # bucket 4: first use
    assert c.total == 1
    assert eng.post_warmup_recompiles == 0
    assert eng.warmed_buckets == (2, 4)


@pytest.mark.parametrize("strict", [False, True])
def test_engine_alarms_on_a_warmed_bucket_it_never_built(world, strict,
                                                         tmp_path):
    """``_warmed.add(4)`` claims bucket 4 warm without a program: the
    next dispatch there is a recompile alarm, raised under strict."""
    from rlgpuschedule_tpu_torch.obs import EventBus
    *_, obs, mask, policy = world
    bus = EventBus(str(tmp_path), rank=0, name="serve")
    eng = InferenceEngine(policy, max_bucket=8, device="cpu", bus=bus,
                          strict=strict)
    eng._warmed.add(4)
    if strict:
        with pytest.raises(RecompileSentinelError, match="bucket 4"):
            eng.decide(obs[:3], mask[:3])
    else:
        got, b = eng.decide(obs[:3], mask[:3])
        assert b == 4 and got.shape == (3,)
        eng.decide(obs[:4], mask[:4])              # built now: no alarm
    assert eng.post_warmup_recompiles == 1
    assert eng.registry.counter("serve_bucket_compiles_total").value == 0
    bus.close()
    assert [e["kind"] for e in read_events(bus.path)] == ["recompile"]


def test_engine_alarms_on_a_dtype_drift(world):
    *_, obs, mask, policy = world
    eng = InferenceEngine(policy, max_bucket=8, device="cpu")
    eng.warmup(obs[0], mask[0], buckets=(8,))
    want = eng.decide(obs[:8], mask[:8])[0]
    got, _ = eng.decide(obs[:8].astype(np.float64), mask[:8])
    assert eng.post_warmup_recompiles == 1
    np.testing.assert_array_equal(got, want)      # f32 values, cast back
    strict = InferenceEngine(policy, max_bucket=8, device="cpu",
                             strict=True)
    strict.warmup(obs[0], mask[0], buckets=(8,))
    with pytest.raises(RecompileSentinelError):
        strict.decide(obs[:8], mask[:8].astype(np.uint8))


def test_param_swap_and_rewarm_build_nothing(world):
    """Swapping weights copies into the parameters in place; the re-warm
    drives every warmed bucket without a build; the actions follow the
    new weights, and swapping back restores the old ones bit for bit."""
    *_, obs, mask, policy = world
    eng = InferenceEngine(policy, max_bucket=16, device="cpu", strict=True)
    with pytest.raises(RuntimeError, match="warmup"):
        eng.rewarm()
    eng.warmup(obs[0], mask[0])
    sd = {k: v.clone() for k, v in policy.state_dict().items()}
    ptrs = [p.data_ptr() for p in policy.parameters()]
    before = eng.decide(obs[:12], mask[:12])[0]
    gen = torch.Generator().manual_seed(1)
    other = {k: torch.randn(v.shape, generator=gen, dtype=v.dtype) * 0.5
             for k, v in sd.items()}
    with CompileCounter() as c:
        eng.set_params(other)
        assert eng.rewarm() == (1, 2, 4, 8, 16)
        after = eng.decide(obs[:12], mask[:12])[0]
        eng.set_params(sd)
        eng.rewarm()
        again = eng.decide(obs[:12], mask[:12])[0]
    assert c.total == 0 and eng.post_warmup_recompiles == 0
    assert [p.data_ptr() for p in policy.parameters()] == ptrs
    np.testing.assert_array_equal(before, again)
    policy.load_state_dict(other)
    with torch.no_grad():
        want = policy_decision(policy, torch.from_numpy(obs[:12]),
                               torch.from_numpy(mask[:12]))
    policy.load_state_dict(sd)
    np.testing.assert_array_equal(after, want.numpy())
    assert (after != before).any()


def test_decide_returns_a_view_of_the_download_buffer(world):
    """The actions land in the key's one preallocated download buffer,
    and decide hands back a copy of its rows taken under the engine's
    lock: a later dispatch at that bucket, or a rewarm, leaves what the
    caller holds as it was."""
    *_, obs, mask, policy = world
    eng = InferenceEngine(policy, max_bucket=8, device="cpu")
    eng.warmup(obs[0], mask[0], buckets=(8,))
    a, _ = eng.decide(obs[:5], mask[:5])
    (prog,) = eng._programs.values()
    np.testing.assert_array_equal(a, prog.host_out_np[:5])
    assert a.dtype == np.int32 and not np.shares_memory(a, prog.host_out_np)
    held = a.copy()
    eng.decide(obs[5:11], mask[5:11])
    eng.rewarm()
    np.testing.assert_array_equal(a, held)


def test_sync_guard_does_nothing_on_the_cpu():
    x = torch.ones(3)
    with no_implicit_transfers("cpu"):
        assert x.sum().item() == 3.0


# ---- the serve CLI's bench, soak and host path on the CPU --------------

CUT = ["--config", "ppo-mlp-synth64", "--n-envs", "2", "--pool-steps", "2",
       "--device", "cpu"]


def _report(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_serve_cli_bench_writes_metrics_and_compile_events(tmp_path,
                                                           capsys):
    obs_dir = tmp_path / "obs"
    serve_cli.main(CUT + ["--bench", "--rounds", "6", "--obs-dir",
                          str(obs_dir), "--trace-spans", "--metrics-port",
                          "0"])
    rep = _report(capsys)
    b = rep["bench"]
    assert rep["repro"]["config"] == "ppo-mlp-synth64"
    assert rep["repro"]["n_envs"] == 2
    assert b["post_warmup_recompiles"] == 0 and b["graphs"] is False
    assert b["requests"] == 2 * (5 + 6 + 8) and b["dispatches"] == 6
    assert rep["scrape"]["well_formed"]
    prom = (obs_dir / "metrics.prom").read_text()
    assert "serve_bucket_compiles_total 1" in prom
    assert "serve_recompile_alarms_total 0" in prom
    events = read_events(str(obs_dir / "events.serve.jsonl"))
    compiles = [e for e in events if e["kind"] == "compile"]
    assert [(e["bucket"], e["program"]) for e in compiles] == [(8, "build")]
    assert {e.get("span") for e in events} >= {"serve_batch", "dispatch",
                                               "enqueue", "served"}


def test_serve_cli_soak_conserves_every_request(capsys):
    serve_cli.main(CUT + ["--soak", "1", "--rate", "150", "--deadline-ms",
                          "50", "--adaptive-wait"])
    rep = _report(capsys)
    s = rep["soak"]
    assert rep["repro"]["n_envs"] == 2
    assert s["served"] + s["shed"] == s["requests"] > 100
    assert s["post_warmup_recompiles"] == 0 and s["dispatch_errors"] == 0


def test_serve_cli_host_path_arena_allocates_nothing(capsys):
    serve_cli.main(CUT + ["--host-path", "--host-rounds", "30"])
    rep = _report(capsys)
    hp = rep["host_path"]
    assert rep["repro"]["config"] == "ppo-mlp-synth64"
    legacy, arena = hp["arms"]
    assert (legacy["data_plane"], arena["data_plane"]) == ("legacy", "arena")
    assert arena["alloc_calls"] == 0 and legacy["alloc_calls"] > 0
    assert arena["conservation_ok"] and arena["served"] == 30 * 8


def test_serve_cli_needs_a_mode_and_a_card():
    with pytest.raises(SystemExit, match="nothing to do"):
        serve_cli.main(["--device", "cpu"])
    with pytest.raises(SystemExit, match="--rate"):
        serve_cli.main(["--bench", "--rate", "5", "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--bench"])


def test_serve_cli_serves_a_checkpoint_in_a_subprocess(tmp_path):
    """``serve --ckpt-dir --fleet`` in its own process serves the actions
    of the trained policy: its fleet table equals an in-process replay
    of the experiment that wrote the checkpoint, and ``repro`` names the
    step restored."""
    from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
    from rlgpuschedule_tpu_torch.experiment import Experiment
    cut = dict(n_envs=2, n_nodes=4, gpus_per_node=4, window_jobs=12,
               queue_len=4, horizon=96)
    base = tconfigs.CONFIGS["ppo-mlp-synth64"]
    cfg = dataclasses.replace(base, **cut, ppo=dataclasses.replace(
        base.ppo, n_steps=8, n_epochs=1, n_minibatches=2))
    exp = Experiment.build(cfg, device="cpu")
    d = str(tmp_path / "ck")
    exp.run(2, ckpt=Checkpointer(d), ckpt_every=1)
    flags = ["--n-envs", "2", "--n-nodes", "4", "--gpus-per-node", "4",
             "--window-jobs", "12", "--queue-len", "4", "--horizon", "96"]
    p = _run(["-m", "rlgpuschedule_tpu_torch.serve", "--config",
              "ppo-mlp-synth64", "--fleet", "3", "--max-steps", "40",
              "--device", "cpu", "--ckpt-dir", d] + flags)
    assert p.returncode == 0, p.stderr
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["repro"]["ckpt_step"] == exp.step == 4
    _, traces = fleet_windows(cfg, 3, source=exp.source, device="cpu")
    want = fleet_replay(exp.net, exp.env_params, traces, max_steps=40,
                        device="cpu")
    assert got["fleet"]["per_cluster"] == want["per_cluster"]
    # an older step by --ckpt-step
    p = _run(["-m", "rlgpuschedule_tpu_torch.serve", "--fleet", "3",
              "--max-steps", "40", "--device", "cpu", "--ckpt-dir", d,
              "--ckpt-step", "2"] + flags)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.strip().splitlines()[-1])[
        "repro"]["ckpt_step"] == 2


@pytest.mark.parametrize("argv,match", [
    (["--weights", "w.npz", "--ckpt-dir", "d"], "pass one"),
    (["--ckpt-step", "4"], "--ckpt-dir"),
])
def test_serve_cli_refuses_ambiguous_weights(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve_cli.main(["--fleet", "2", "--device", "cpu"] + argv)


def test_fleet_windows_take_a_source_and_a_start_like_jax():
    from rlgpuschedule_tpu.serve.fleet import fleet_windows as jfleet
    from rlgpuschedule_tpu_torch.experiment import load_source_trace
    cut = dict(n_nodes=4, gpus_per_node=4, window_jobs=12, queue_len=4,
               drain_frac=0.5)
    cj = dataclasses.replace(jconfigs.CONFIGS["ppo-mlp-synth64"], **cut)
    ct = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"], **cut)
    from rlgpuschedule_tpu.experiment import load_source_trace as jload
    for start in (0, 5):
        wj, _ = jfleet(cj, 3, source=jload(cj, n_jobs=60, seed=4),
                       start=start)
        wt, traces = fleet_windows(ct, 3, load_source_trace(
            ct, n_jobs=60, seed=4), start, device="cpu")
        for a, b in zip(wj, wt):
            for f in ("submit", "duration", "gpus", "valid"):
                assert np.asarray(getattr(a, f)).tobytes() == \
                    getattr(b, f).tobytes(), (start, f)
        assert traces.submit.shape == (3, 12)
