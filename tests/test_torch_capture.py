"""The flywheel's tap: ``policy_decision_full``, the engine's capture
mode and the server's flight log, against the JAX package and on their
own.

- ``policy_decision_full`` against JAX's on the same rows and converted
  weights: config 1 cut to 4 x 4 GPUs (one head) and config 5's
  hierarchical policy (two heads, the joint log-prob summed over the
  pods): actions equal, log-prob and value within 1e-5 (f32).
- A capture engine decides the plain engine's actions, with the
  log-prob and value of ``policy_decision_full`` on the padded batch;
  weights swapped into it re-warm every bucket with 0 recompiles.
- Through ``PolicyServer`` with a capture engine and a writer, on both
  data planes, under a burst that sheds: ``rows_logged == served``, and
  the crc-verified log holds what was served (obs, mask, action, stall,
  request id, deadline outcome) bit for bit.
- A writer over a plain engine raises ``ValueError``; a failing append
  fails its batch's futures.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu.decision import \
    policy_decision_full as jpolicy_decision_full
from rlgpuschedule_tpu.experiment import build_env_params as jbuild
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu.models.hier import HierActorCritic as JHier
from rlgpuschedule_tpu_torch import configs as tconfigs
from rlgpuschedule_tpu_torch.decision import (policy_decision,
                                              policy_decision_full,
                                              stall_threshold)
from rlgpuschedule_tpu_torch.experiment import build_env_params as tbuild
from rlgpuschedule_tpu_torch.experiment import build_hier_params
from rlgpuschedule_tpu_torch.flywheel import FlightLogWriter, read_flight_log
from rlgpuschedule_tpu_torch.models import (make_hier_policy, make_policy,
                                            params_from_jax)
from rlgpuschedule_tpu_torch.obs import Registry
from rlgpuschedule_tpu_torch.serve import (InferenceEngine, PolicyServer,
                                           build_request_pool,
                                           stack_requests)
from rlgpuschedule_tpu_torch.serve.batching import DeadlineSheddedError
from rlgpuschedule_tpu_torch.serve.fleet import fleet_windows

torch.set_num_threads(1)

SMALL = dict(n_envs=2, window_jobs=12, horizon=96, n_nodes=4,
             gpus_per_node=4, queue_len=4)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def flat():
    """Config 1 cut small with the preempt slots on (so the stall gate
    is live): JAX's f32 policy, the port's twin with the converted
    weights, and 64 seeded request rows (every mask keeps the no-op)."""
    over = dict(SMALL, preempt_len=2)
    jcfg = dataclasses.replace(jconfigs.CONFIGS["ppo-mlp-synth64"], **over)
    tcfg = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"], **over)
    jp, tp = jbuild(jcfg), tbuild(tcfg)
    net = jmake_policy("flat", jp.n_actions, dtype=jnp.float32)
    params = jax.device_get(jax.jit(net.init)(
        jax.random.PRNGKey(0), jnp.zeros((1,) + jp.obs_shape()),
        jnp.ones((1, jp.n_actions), bool)))
    policy = make_policy("flat", tp.n_actions, tp.obs_shape(),
                         dtype=torch.float32, device="cpu")
    policy.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(7)
    obs = rng.standard_normal((64,) + tp.obs_shape()).astype(np.float32)
    mask = rng.random((64, tp.n_actions)) < 0.6
    mask[:, -1] = True
    return dict(tp=tp, net=net, params=params, policy=policy, obs=obs,
                mask=mask)


@pytest.fixture(scope="module")
def hier():
    """Config 5 at its width: a 12-row pool from the port's env, JAX's
    f32 weights (heads scaled by 300 so the actions depend on them) and
    the port's copy."""
    cfg = dataclasses.replace(tconfigs.CONFIGS["hier-pbt-member"], n_envs=2)
    tp = build_hier_params(cfg)
    seeded = make_hier_policy(tp, dtype=torch.float32, device="cpu")
    _, traces = fleet_windows(cfg, cfg.n_envs, device="cpu")
    pool = build_request_pool(seeded, tp, traces, steps=6)
    obs = stack_requests([o for o, _ in pool])
    mask = stack_requests([m for _, m in pool])
    jnet = JHier(n_top_actions=tp.n_top_actions,
                 n_pod_actions=tp.pod_sim.n_actions, dtype=jnp.float32)
    params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(0), obs,
                                               mask))
    for head in ("top_policy", "pod_policy"):
        k = params["params"][head]["kernel"]
        params["params"][head]["kernel"] = np.asarray(k) * np.float32(300)
    policy = make_hier_policy(tp, dtype=torch.float32, device="cpu")
    policy.load_state_dict(params_from_jax(params))
    return dict(tp=tp, net=jnet, params=params, policy=policy, obs=obs,
                mask=mask)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: torch.from_numpy(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


@pytest.mark.parametrize("which", ["flat", "hier"])
def test_policy_decision_full_matches_jax(which, flat, hier):
    w = flat if which == "flat" else hier
    net = w["net"]
    want = jax.device_get(jax.jit(
        lambda p, o, m: jpolicy_decision_full(
            lambda *a: net.apply(*a), p, o, m))(
        w["params"], w["obs"], w["mask"]))
    with torch.no_grad():
        acts, lp, val = policy_decision_full(w["policy"], _torch(w["obs"]),
                                             _torch(w["mask"]))
        plain = policy_decision(w["policy"], _torch(w["obs"]),
                                _torch(w["mask"]))
    assert lp.dtype == val.dtype == torch.float32
    heads = list(acts) if which == "hier" else [None]
    for k in heads:
        a = acts[k] if k else acts
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(want[0][k] if k else want[0]))
        assert torch.equal(a, plain[k] if k else plain)
    np.testing.assert_allclose(lp.numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(val.numpy(), np.asarray(want[2]), **TOL)
    if which == "hier":
        # the joint log-prob sums the router head and every pod head
        assert w["obs"]["pods"].shape[1] > 1 and (lp.numpy() <= 0).all()


def test_capture_engine_decides_the_plain_engines_actions(flat):
    pol, tp = flat["policy"], flat["tp"]
    plain = InferenceEngine(pol, max_bucket=8, device="cpu", env_params=tp,
                            strict=True)
    cap = InferenceEngine(pol, max_bucket=8, device="cpu", env_params=tp,
                          strict=True, capture=True)
    assert cap.capture and not plain.capture
    for e in (plain, cap):
        e.warmup(flat["obs"][0], flat["mask"][0])
    thresh = stall_threshold(tp)
    rng = np.random.default_rng(1)
    for i, n in enumerate((1, 3, 5, 8, 7)):
        rows = rng.integers(0, 64, n)
        obs, mask = flat["obs"][rows], flat["mask"][rows]
        mask[:, :] = True
        stall = np.where(np.arange(n) % 2 == 0, thresh, 0).astype(np.int32)
        a, b = plain.decide(obs, mask, stall)
        (ac, lp, val), bc = cap.decide(obs, mask, stall)
        assert b == bc and ac.dtype == np.int32
        assert lp.dtype == val.dtype == np.float32 and lp.shape == (n,)
        np.testing.assert_array_equal(a, ac)
        with torch.no_grad():
            gated = torch.from_numpy(mask) & ~(
                (torch.from_numpy(stall) >= thresh)[:, None]
                & torch.from_numpy(_pre(tp)))
            _, want_lp, want_v = policy_decision_full(
                pol, torch.from_numpy(obs), gated)
        np.testing.assert_allclose(lp, want_lp.numpy(), **TOL)
        np.testing.assert_allclose(val, want_v.numpy(), **TOL)
    # a swap into the capture engine re-warms every bucket, building
    # nothing; the incumbent back gives the same triple
    before = cap.decide(flat["obs"][:5], flat["mask"][:5])[0]
    inc = {k: v.clone() for k, v in pol.state_dict().items()}
    cap.set_params({k: v + 0.125 for k, v in inc.items()})
    assert cap.rewarm() == (1, 2, 4, 8)
    cap.set_params(inc)
    cap.rewarm()
    after = cap.decide(flat["obs"][:5], flat["mask"][:5])[0]
    for x, y in zip(before, after):
        np.testing.assert_array_equal(x, y)
    assert cap.post_warmup_recompiles == plain.post_warmup_recompiles == 0


def _pre(tp):
    from rlgpuschedule_tpu_torch.decision import preempt_slice
    return preempt_slice(tp).numpy()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("plane", ["arena", "legacy"])
def test_server_logs_every_served_row_and_nothing_else(tmp_path, flat,
                                                       plane):
    """A burst that expires in the queue, rows with a deadline met and
    missed, rows without one: ``rows_logged == served``, and the log
    holds what each served future got."""
    reg = Registry()
    eng = InferenceEngine(flat["policy"], max_bucket=8, device="cpu",
                          env_params=flat["tp"], capture=True)
    eng.warmup(flat["obs"][0], flat["mask"][0])
    clock = _Clock()
    decide = eng.decide

    def slow_decide(*a):
        clock.t += 0.5          # every dispatch takes 0.5 s of the clock
        return decide(*a)
    eng.decide = slow_decide
    writer = FlightLogWriter(str(tmp_path / "flog"), capacity=6,
                             registry=reg, policy_step=9)
    server = PolicyServer(eng, registry=reg, clock=clock, data_plane=plane,
                          example_obs=flat["obs"][0],
                          example_mask=flat["mask"][0], flight_log=writer)
    obs, mask = flat["obs"], flat["mask"]
    subs = []                   # (future, row, stall, deadline)

    def submit(i, deadline=None, stall=0):
        subs.append((server.submit(obs[i], mask[i], stall=stall,
                                   deadline_s=deadline), i, stall,
                     deadline))
    for i in range(5):
        submit(i, stall=i)                       # no deadline
    for i in range(5, 9):
        submit(i, deadline=10.0)                 # met
    while server.pump():
        pass
    for i in range(9, 13):
        submit(i, deadline=0.01)                 # expire in the queue
    clock.t += 1.0
    for i in range(13, 16):
        submit(i, deadline=0.2)                  # served late
    while server.pump():
        pass
    server.close()
    writer.close()
    served, shed = [], 0
    for fut, i, stall, deadline in subs:
        try:
            r = fut.result(timeout=10)
        except DeadlineSheddedError:
            shed += 1
            continue
        served.append((r, i, stall, deadline))
    assert shed >= 4 and len(served) == len(subs) - shed
    assert writer.rows_logged == len(served)
    assert "flywheel_rows_logged_total %d" % len(served) in reg.render()
    data = read_flight_log(str(tmp_path / "flog"))
    assert not data.torn_tail and data.rows == len(served)
    cat = data.concat()
    assert cat.policy_step == 9
    by_id = {int(r): j for j, r in enumerate(cat.req_id)}
    assert len(by_id) == len(served)
    outcomes = set()
    for r, i, stall, deadline in served:
        j = by_id[r.req_id]
        np.testing.assert_array_equal(cat.obs_leaves[0][j], obs[i])
        np.testing.assert_array_equal(cat.mask_leaves[0][j], mask[i])
        assert cat.act_leaves[0][j] == r.action and cat.stall[j] == stall
        want = (0 if deadline is None
                else 1 if r.latency_s <= deadline else 2)
        assert cat.outcome[j] == want
        outcomes.add(want)
    assert outcomes == {0, 1, 2}
    # the logged behavior columns are the capture graph's own
    with torch.no_grad():
        _, lp, val = policy_decision_full(
            flat["policy"], torch.from_numpy(cat.obs_leaves[0]),
            torch.from_numpy(cat.mask_leaves[0]))
    np.testing.assert_allclose(cat.log_prob, lp.numpy(), **TOL)
    np.testing.assert_allclose(cat.value, val.numpy(), **TOL)


def test_a_writer_needs_a_capture_engine(tmp_path, flat):
    eng = InferenceEngine(flat["policy"], max_bucket=8, device="cpu")
    with pytest.raises(ValueError, match="capture"):
        PolicyServer(eng, flight_log=FlightLogWriter(str(tmp_path)))


def test_a_failing_append_fails_its_futures(tmp_path, flat):
    eng = InferenceEngine(flat["policy"], max_bucket=8, device="cpu",
                          capture=True)
    eng.warmup(flat["obs"][0], flat["mask"][0])
    writer = FlightLogWriter(str(tmp_path))

    def boom(*a, **kw):
        raise RuntimeError("disk gone")
    writer.append_batch = boom
    server = PolicyServer(eng, flight_log=writer)
    server.start()
    try:
        fut = server.submit(flat["obs"][0], flat["mask"][0])
        with pytest.raises(RuntimeError, match="disk gone"):
            fut.result(timeout=30)
    finally:
        server.close()
