"""Config 5 (``hier-pbt-member``) served through the port's engine and
policy server: dict observations per request, per-head actions.

- The engine against the JAX package's ``InferenceEngine`` on the same
  request pool (config 5's width, the port's env stepped under the
  greedy policy) and the same f32 weights, carried from a JAX ``init``
  by ``models/convert.py`` with the policy heads scaled up so the
  actions depend on them: per head, the served actions are identical
  (one JAX program: bucket 8).
- The server, on both data planes and over the dispatcher thread,
  scatters each request its own dict of actions.
- ``serve --bench --soak`` of the preset runs as a subprocess.
"""
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

from rlgpuschedule_tpu.models.hier import HierActorCritic as JHier
from rlgpuschedule_tpu.obs import Registry as JRegistry
from rlgpuschedule_tpu.serve.engine import InferenceEngine as JEngine
from rlgpuschedule_tpu_torch.configs import CONFIGS
from rlgpuschedule_tpu_torch.decision import policy_decision
from rlgpuschedule_tpu_torch.experiment import build_hier_params
from rlgpuschedule_tpu_torch.models import make_hier_policy, params_from_jax
from rlgpuschedule_tpu_torch.serve import (InferenceEngine, PolicyServer,
                                           build_request_pool,
                                           stack_requests)
from rlgpuschedule_tpu_torch.serve.fleet import fleet_windows

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dataclasses.replace(CONFIGS["hier-pbt-member"], n_envs=4)
SIZES = (5, 7, 8)


@pytest.fixture(scope="module")
def world():
    """Config 5's env params, a 16-row request pool from its env, the
    JAX policy's f32 weights (heads scaled by 300) and the port's copy."""
    tp = build_hier_params(CFG)
    seeded = make_hier_policy(tp, dtype=torch.float32, device="cpu")
    _, traces = fleet_windows(CFG, CFG.n_envs, device="cpu")
    pool = build_request_pool(seeded, tp, traces, steps=3)
    jnet = JHier(n_top_actions=tp.n_top_actions,
                 n_pod_actions=tp.pod_sim.n_actions, dtype=jnp.float32)
    obs = stack_requests([o for o, _ in pool[:2]])
    mask = stack_requests([m for _, m in pool[:2]])
    params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(0), obs,
                                               mask))
    for head in ("top_policy", "pod_policy"):
        k = params["params"][head]["kernel"]
        params["params"][head]["kernel"] = np.asarray(k) * np.float32(300)
    policy = make_hier_policy(tp, dtype=torch.float32, device="cpu")
    policy.load_state_dict(params_from_jax(params))
    return dict(tp=tp, pool=pool, jnet=jnet, params=params, policy=policy)


def _batch(pool, n, start=0):
    rows = [pool[(start + i) % len(pool)] for i in range(n)]
    return (stack_requests([o for o, _ in rows]),
            stack_requests([m for _, m in rows]))


def test_tree_helpers_walk_as_jax_tree_does(world):
    """The port's torch-free tree helpers flatten a request as
    ``jax.tree`` does (dict keys sorted, whatever the insertion order),
    and rebuild, stack and index it leaf by leaf."""
    from collections import namedtuple

    from rlgpuschedule_tpu_torch import tree
    obs, mask = world["pool"][0]
    nt = namedtuple("NT", "a b")
    for t in (obs, {"pods": obs["pods"], "top": obs["top"]},
              (mask, [obs["top"], 3]), nt(obs["top"], {"z": 1, "y": 2})):
        got, want = tree.leaves(t), jax.tree.leaves(t)
        assert len(got) == len(want)
        assert all(x is y for x, y in zip(got, want))
        back = tree.unflatten(t, got)
        assert jax.tree.structure(back) == jax.tree.structure(t)
    rows = [world["pool"][i][0] for i in range(3)]
    stacked = tree.stack(rows)
    want = jax.tree.map(lambda *xs: np.stack(xs), *rows)
    for k in ("top", "pods"):
        np.testing.assert_array_equal(stacked[k], want[k])
        np.testing.assert_array_equal(tree.index(stacked, 1)[k], rows[1][k])
    assert tree.structure(obs) == tree.structure(
        {"pods": obs["pods"], "top": obs["top"]})
    with pytest.raises(ValueError, match="more leaves"):
        tree.unflatten(obs, [1, 2, 3])


def test_pool_rows_are_dicts_of_the_env_shapes(world):
    tp, pool = world["tp"], world["pool"]
    assert len(pool) == CFG.n_envs * 4
    obs, mask = pool[0]
    shapes = tp.obs_shape()
    assert {k: v.shape for k, v in obs.items()} == {
        k: tuple(s) for k, s in shapes.items()}
    assert mask["top"].shape == (tp.n_pods + 1,) and mask["top"][-1]
    assert mask["pods"].shape == (tp.n_pods, tp.pod_sim.n_actions)
    assert obs["top"].dtype == np.float32 and mask["pods"].dtype == bool


def test_engine_matches_the_jax_engine_per_head(world):
    pool, policy = world["pool"], world["policy"]
    jengine = JEngine(lambda p, o, m: world["jnet"].apply(p, o, m),
                      world["params"], max_bucket=8, registry=JRegistry(),
                      stall_gate=False)
    engine = InferenceEngine(policy, max_bucket=8, device="cpu",
                             env_params=world["tp"])
    obs0, mask0 = pool[0]
    jengine.warmup(obs0, mask0, buckets=(8,))
    engine.warmup(obs0, mask0, buckets=(8,))
    routed = 0
    for i, n in enumerate(SIZES * 2):
        obs, mask = _batch(pool, n, start=3 * i)
        got, b = engine.decide(obs, mask)
        want, jb = jengine.decide(obs, mask)
        assert b == jb == 8
        assert set(got) == {"top", "pods"}
        for k in got:
            assert got[k].dtype == np.int32 and got[k].shape[0] == n
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)
        routed += int((got["top"] < world["tp"].n_pods).sum())
        with torch.no_grad():
            eager = policy_decision(
                policy, {k: torch.from_numpy(v) for k, v in obs.items()},
                {k: torch.from_numpy(v) for k, v in mask.items()})
        for k in got:
            np.testing.assert_array_equal(got[k], eager[k].numpy())
    assert routed > 0
    assert engine.post_warmup_recompiles == 0
    assert engine._pre is None          # the pods cannot preempt


@pytest.mark.parametrize("plane", ["arena", "legacy"])
def test_server_scatters_dict_actions(world, plane):
    pool, policy = world["pool"], world["policy"]
    engine = InferenceEngine(policy, max_bucket=8, device="cpu",
                             env_params=world["tp"])
    obs0, mask0 = pool[0]
    engine.warmup(obs0, mask0)
    server = PolicyServer(engine, data_plane=plane, example_obs=obs0,
                          example_mask=mask0)
    futs = [server.submit(*pool[i]) for i in range(7)]
    assert server.pump() == 7
    want, _ = engine.decide(*_batch(pool, 7))
    for i, f in enumerate(futs):
        a = f.result(timeout=10).action
        assert set(a) == {"top", "pods"}
        assert a["pods"].shape == (world["tp"].n_pods,)
        assert int(a["top"]) == want["top"][i]
        np.testing.assert_array_equal(a["pods"], want["pods"][i])
    if plane == "arena":
        # a row of another structure is refused at the door
        with pytest.raises(ValueError, match="structured"):
            server.submit({"top": obs0["top"]}, mask0)
    server.start()
    try:
        futs = [server.submit(*pool[i % len(pool)]) for i in range(40)]
        got = [f.result(timeout=30).action for f in futs]
    finally:
        server.stop()
    want, _ = engine.decide(*_batch(pool, 8))
    for i in range(8):
        assert int(got[i]["top"]) == want["top"][i]
    assert engine.post_warmup_recompiles == 0
    server.close()


def test_serve_cli_benches_and_soaks_config_5():
    p = subprocess.run(
        [sys.executable, "-m", "rlgpuschedule_tpu_torch.serve", "--config",
         "hier-pbt-member", "--bench", "--n-envs", "2", "--pool-steps", "1",
         "--rounds", "4", "--soak", "1", "--rate", "100", "--deadline-ms",
         "200", "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["config"] == "hier-pbt-member"
    bench, soak = out["bench"], out["soak"]
    assert bench["requests"] > 0 and bench["post_warmup_recompiles"] == 0
    assert soak["served"] + soak["shed"] == soak["requests"] > 50
    assert soak["post_warmup_recompiles"] == 0
    assert soak["dispatch_errors"] == 0
