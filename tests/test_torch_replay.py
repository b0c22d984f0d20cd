"""The slice as a whole: greedy fleet replay in both packages.

Configs 1 and 2 at a small size (config 2 with an odd node-plus-queue
count) go through both packages' ``fleet_windows`` and greedy replay
with the same f32 weights (JAX init, converted). The windows must be
byte-equal; the greedy action sequence identical at every step each
cluster takes; per-cluster ``steps`` and ``n_done`` identical; and
``avg_jct``, ``makespan`` and ``utilization`` within rtol 1e-6. If the
actions diverge, the failure names the step and the JAX logit margin
there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu import eval as jeval
from rlgpuschedule_tpu.env import env as jenv
from rlgpuschedule_tpu.experiment import build_env_params as jbuild
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu.serve.fleet import fleet_windows as jfleet_windows
from rlgpuschedule_tpu_torch import configs as tconfigs
from rlgpuschedule_tpu_torch.eval import replay
from rlgpuschedule_tpu_torch.experiment import build_env_params as tbuild
from rlgpuschedule_tpu_torch.models import make_policy, params_from_jax
from rlgpuschedule_tpu_torch.serve.fleet import fleet_replay, fleet_windows

# the tensors here are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

E = 4
SMALL = {
    "ppo-mlp-synth64": dict(n_nodes=8, gpus_per_node=4, window_jobs=32,
                            queue_len=4, horizon=128),
    "ppo-cnn-philly512": dict(n_nodes=9, gpus_per_node=4, window_jobs=32,
                              queue_len=4, horizon=128),
}


def _jax_actions(apply_fn, params, env_params, traces, steps):
    """Per-step greedy actions and top-two logits ``[steps, E, 2]`` of
    the JAX policy, frozen per cluster once done (as ``eval.replay``
    freezes)."""
    state, ts = jax.jit(lambda tr: jenv.vec_reset(env_params, tr))(traces)
    step = jax.vmap(lambda s, tr, a: jenv.step(env_params, s, tr, a))

    def body(carry, _):
        state, obs, mask, done = carry
        logits, _ = apply_fn(params, obs, mask)
        a = jnp.argmax(logits, -1)
        top2 = jax.lax.top_k(logits, 2)[0]
        new_state, new_ts = step(state, traces, a)
        keep = lambda o, n: jnp.where(
            done.reshape((-1,) + (1,) * (n.ndim - 1)), o, n)
        state = jax.tree.map(keep, state, new_state)
        carry = (state, keep(obs, new_ts.obs),
                 keep(mask, new_ts.action_mask), done | new_ts.done)
        return carry, (a, top2)

    init = (state, ts.obs, ts.action_mask, jnp.zeros(ts.done.shape, bool))
    _, (acts, top2) = jax.jit(
        lambda c: jax.lax.scan(body, c, None, length=steps))(init)
    return np.asarray(acts), np.asarray(top2)


def _both(name, dtype, policy_gain=1.0):
    """The config's small fleet windows and one JAX-initialised policy
    (its policy head scaled by ``policy_gain``) in both packages."""
    cfg_j = dataclasses.replace(jconfigs.CONFIGS[name], **SMALL[name])
    cfg_t = dataclasses.replace(tconfigs.CONFIGS[name], **SMALL[name])
    jwin, jtraces = jfleet_windows(cfg_j, E)
    twin, ttraces = fleet_windows(cfg_t, E, device="cpu")
    for a, b in zip(jwin, twin):
        for f in ("submit", "duration", "gpus", "tenant", "valid"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f

    jp, tp = jbuild(cfg_j), tbuild(cfg_t)
    _, ts0 = jax.jit(lambda tr: jenv.vec_reset(jp, tr))(jtraces)
    net = jmake_policy(cfg_j.obs_kind, jp.n_actions,
                       dtype=getattr(jnp, dtype))
    params = jax.device_get(jax.jit(net.init)(
        jax.random.PRNGKey(cfg_j.seed), ts0.obs, ts0.action_mask))
    head = params["params"]["policy"]
    head["kernel"] = np.asarray(head["kernel"]) * np.float32(policy_gain)
    apply_fn = lambda p, o, m: net.apply(p, o, m)
    policy = make_policy(cfg_t.obs_kind, tp.n_actions, tp.obs_shape(),
                         dtype=getattr(torch, dtype), device="cpu")
    policy.load_state_dict(params_from_jax(params))
    return (apply_fn, params, jp, jtraces), (policy, tp, ttraces)


def _assert_same_outcome(jres, tres, clusters):
    for k in ("steps", "n_done", "n_valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jres, k))[clusters],
                                      getattr(tres, k).numpy()[clusters],
                                      err_msg=k)
    for f in ("avg_jct", "makespan", "utilization"):
        np.testing.assert_allclose(getattr(tres, f).numpy()[clusters],
                                   np.asarray(getattr(jres, f))[clusters],
                                   rtol=1e-6, err_msg=f)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_greedy_fleet_replay_matches_jax(name):
    (apply_fn, params, jp, jtraces), (policy, tp, ttraces) = _both(
        name, "float32")
    jres = jeval.replay(apply_fn, params, jp, jtraces)
    tres, rec = replay(policy, tp, ttraces, record=True)
    steps = np.asarray(jres.steps)
    np.testing.assert_array_equal(steps, tres.steps.numpy())
    jacts, jtop2 = _jax_actions(apply_fn, params, jp, jtraces,
                                int(steps.max()))
    jmargin = jtop2[..., 0] - jtop2[..., 1]
    tacts = rec.actions.numpy()
    for e in range(E):
        diff = np.flatnonzero(jacts[:steps[e], e] != tacts[:steps[e], e])
        assert diff.size == 0, (
            f"cluster {e}: greedy actions diverge at step {diff[0]} "
            f"(JAX top-two logit margin there {jmargin[diff[0], e]:.3g})")
    _assert_same_outcome(jres, tres, np.arange(E))
    assert int(tres.n_done.sum()) > 0

    # the fleet entry point reports the same per-cluster table, pooled
    # as the JAX package's fleet_replay pools it
    tfl = fleet_replay(policy, tp, ttraces, device="cpu")
    pc = tfl["per_cluster"]
    assert tfl["n_clusters"] == E and tfl["decisions"] == int(steps.sum())
    assert pc["steps"] == steps.tolist()
    assert pc["n_done"] == np.asarray(jres.n_done).tolist()
    np.testing.assert_allclose(pc["avg_jct"], np.asarray(jres.avg_jct),
                               rtol=1e-6)
    want_jct, want_completion = jeval.pooled_avg_jct(jres)
    np.testing.assert_allclose(tfl["mean_jct"], want_jct, rtol=1e-6)
    assert tfl["completion"] == want_completion
    jkeys = ("n_clusters mean_jct completion decisions wall_s "
             "decisions_per_s decisions_per_s_per_chip n_chips max_steps "
             "per_cluster").split()
    assert set(jkeys) <= set(tfl)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_bf16_greedy_replay_matches_jax(name):
    """The served default precision. The two packages' bf16 logits
    agree within atol = rtol = 2e-2 (``test_torch_models``), so greedy
    actions may part only where the JAX top-two margin is inside that
    band. The policy head is scaled by 100 so the logits are O(1), as a
    trained policy's are. A cluster is compared up to its first such
    step; the clusters that never part must end exactly as in JAX."""
    tol = 2e-2
    (apply_fn, params, jp, jtraces), (policy, tp, ttraces) = _both(
        name, "bfloat16", policy_gain=100.0)
    jres = jeval.replay(apply_fn, params, jp, jtraces)
    tres, rec = replay(policy, tp, ttraces, record=True)
    steps = np.minimum(np.asarray(jres.steps), tres.steps.numpy())
    jacts, jtop2 = _jax_actions(apply_fn, params, jp, jtraces,
                                int(steps.max()))
    jmargin = jtop2[..., 0] - jtop2[..., 1]
    tacts = rec.actions.numpy()
    to_end = []
    for e in range(E):
        diff = np.flatnonzero(jacts[:steps[e], e] != tacts[:steps[e], e])
        if diff.size == 0:
            to_end.append(e)
            continue
        s = diff[0]
        band = 2 * tol * (1 + abs(jtop2[s, e, 0]))
        assert jmargin[s, e] < band, (
            f"cluster {e}: bf16 greedy actions diverge at step {s} where "
            f"the JAX top-two logit margin {jmargin[s, e]:.3g} is wider "
            f"than the bf16 band {band:.3g}")
    assert len(to_end) >= E // 2, f"only clusters {to_end} ran in step"
    _assert_same_outcome(jres, tres, np.array(to_end))


def test_fleet_replay_runs_on_cuda_by_default_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"],
                              **SMALL["ppo-mlp-synth64"])
    _, traces = fleet_windows(cfg, 2, device="cpu")
    tp = tbuild(cfg)
    policy = make_policy("flat", tp.n_actions, tp.obs_shape(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet_replay(policy, tp, traces)
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet_windows(cfg, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_policy("flat", tp.n_actions, tp.obs_shape())


def test_replay_freezes_finished_clusters_and_stops_early():
    cfg = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"],
                              **dict(SMALL["ppo-mlp-synth64"], horizon=1000))
    _, traces = fleet_windows(cfg, 2, device="cpu")
    tp = tbuild(cfg)
    policy = make_policy("flat", tp.n_actions, tp.obs_shape(), device="cpu")
    res, rec = replay(policy, tp, traces, record=True)
    assert (res.n_done == res.n_valid).all()
    # every cluster finished well inside the horizon; the loop stopped at
    # the first 64-step check after the last one did, and a replay cut at
    # the last cluster's final step reports the same
    last = int(res.steps.max())
    assert rec.actions.shape[0] == -(-last // 64) * 64 < 1000
    for a, b in zip(res, replay(policy, tp, traces, max_steps=last)):
        assert torch.equal(a, b)
