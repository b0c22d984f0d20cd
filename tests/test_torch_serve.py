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
from rlgpuschedule_tpu_torch.serve import InferenceEngine
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
    p = _run(["-m", "rlgpuschedule_tpu_torch.serve", "--config",
              "ppo-mlp-synth64", "--fleet", "2", "--device", "cpu",
              "--fleet-regime", "storm"])
    assert p.returncode != 0 and "NotImplementedError" in p.stderr
    p = _run(["-m", "rlgpuschedule_tpu_torch.serve", "--config",
              "hier-pbt-member", "--fleet", "2", "--device", "cpu"])
    assert p.returncode != 0 and "NotImplementedError" in p.stderr
    assert "hier-pbt-member" in p.stderr


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
