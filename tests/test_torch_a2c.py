"""Parity of the port's config-3 and advantage-option building blocks
with the JAX package's, at a small size, f32 unless a case says bf16.

Each test runs the JAX function (jitted, as its callers run it) and the
port's counterpart on the same numpy-seeded inputs and weights (the JAX
init converted with ``params_from_jax``):

- ``tenant_counts``/``reward_fair``: a rollout of integer-valued
  PAI-proxy windows replaying JAX's sampled actions under the fairness
  reward (tenant ids past ``n_tenants`` included): mask, reward, done and
  every tenant count bit-identical, the observations within the env
  tolerance of ``tests/test_torch_sim.py`` (rtol 1e-6, atol 1e-7: tanh);
- ``ClippedRMSprop`` against ``optax.chain(clip_by_global_norm,
  rmsprop)`` over 5 steps, two of them clipped: within 1e-6;
- the A2C learn step from a JAX state taken mid-run, at 1 x 1 and at
  2 x 2 with JAX's permutations, plain, with ``reward_norm`` and with
  ``bf16_advantages``: parameters within atol 1e-5, metrics within
  rtol 1e-4 / atol 1e-6 (``tests/test_torch_train.py``'s learn-step
  tolerances);
- the Welford reward moments after 3 batches and through a PPO learn
  step: within rtol 1e-6 (an f32 mean, summed in another order);
- ``compute_vtrace`` within 2 f32 ulp of JAX's (the f64 sum of
  ``ops/gae.py``), ratios clipped at ``rho_bar``/``c_bar``; at unit
  ratios it is the port's GAE bit for bit; PPO's V-trace path on an
  on-policy rollout gives ratios within 1e-6 of 1 (torch's CPU matmul
  rounds a batch of another size differently) and GAE's targets within
  atol 1e-5, and exactly 1 and GAE's bits on log-probs recomputed at the
  batch's own size;
- ``bf16_update``: parameters, grads and optimizer moments stay f32 and
  the step is within atol 1e-3 of JAX's bf16 step (the bf16 band of
  ``tests/test_torch_train.py``); ``bf16_advantages`` stores bf16 targets
  within JAX's own band of the f32 pipeline (atol 0.05, rtol 0.02).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState as JTrainState

from rlgpuschedule_tpu.algos import a2c as ja2c
from rlgpuschedule_tpu.algos import action_dist as jdist
from rlgpuschedule_tpu.algos import ppo as jppo
from rlgpuschedule_tpu.algos import vtrace as jvtrace
from rlgpuschedule_tpu.algos.rollout import Transition as JTransition
from rlgpuschedule_tpu.algos.rollout import init_carry as jinit_carry
from rlgpuschedule_tpu.algos.rollout import rollout as jrollout
from rlgpuschedule_tpu.env import env as jenv
from rlgpuschedule_tpu.env import rewards as jrewards
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu.sim import core as jcore
from rlgpuschedule_tpu_torch.algos import a2c as ta2c
from rlgpuschedule_tpu_torch.algos import action_dist as tdist
from rlgpuschedule_tpu_torch.algos import ppo as tppo
from rlgpuschedule_tpu_torch.algos import vtrace as tvtrace
from rlgpuschedule_tpu_torch.algos.rollout import Transition, init_carry
from rlgpuschedule_tpu_torch.algos.rollout import rollout
from rlgpuschedule_tpu_torch.env import env as tenv
from rlgpuschedule_tpu_torch.env import rewards as trewards
from rlgpuschedule_tpu_torch.models import make_policy, params_from_jax
from rlgpuschedule_tpu_torch.ops import compute_gae
from rlgpuschedule_tpu_torch.sim import core as tcore
from rlgpuschedule_tpu_torch.traces import gen_pai_proxy_trace

N, G, J, K = 4, 4, 16, 3
A = K + 1
T, E = 8, 4
OBS = (N + 4 * K + 2,)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the tensors are tiny: more threads only contend with other workers
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _ulps(x, y):
    xi = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    yi = np.asarray(y, np.float32).view(np.int32).astype(np.int64)
    xi = np.where(xi < 0, np.int64(-2**31) - xi, xi)
    yi = np.where(yi < 0, np.int64(-2**31) - yi, yi)
    return np.where(x == y, 0, np.abs(xi - yi))


# ---- the fairness reward ----------------------------------------------------

def _pai_windows(n_tenants):
    """Integer-valued PAI-proxy windows (the port's generator gives the
    JAX one's bytes, tests/test_torch_traces.py)."""
    out = []
    for s in range(E):
        tr = gen_pai_proxy_trace(J, s, max_jobs=J, n_gpus=N * G, load=2.0,
                                 max_gang=N * G, n_tenants=n_tenants)
        out.append(dataclasses.replace(
            tr, submit=np.where(tr.valid, np.round(tr.submit / 20.0),
                                np.inf).astype(np.float32),
            duration=np.maximum(np.round(tr.duration / 20.0), 1.0
                                ).astype(np.float32)))
    return out


def test_fair_reward_rollout_replaying_jax_actions_matches_jax():
    kw = dict(obs_kind="flat", reward_kind="fair", n_tenants=3, horizon=6,
              reward_scale=1e4, time_scale=600.0, place_bonus=0.05)
    jp = jenv.EnvParams(sim=jcore.SimParams(N, G, J, K), **kw)
    tp = tenv.EnvParams(sim=tcore.SimParams(N, G, J, K), **kw)
    wins = _pai_windows(n_tenants=5)       # ids 3, 4 fall outside the bins
    assert max(int(w.tenant[w.valid].max()) for w in wins) >= 3
    jtr = jenv.stack_traces(wins, jp)
    ttr = tenv.stack_traces(wins, tp, device="cpu")
    jnet = jmake_policy("flat", A, dtype=jnp.float32)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0),
                                np.zeros((1,) + OBS, np.float32),
                                np.ones((1, A), bool))
    apply_fn = lambda p, o, m: jnet.apply(p, o, m)
    carry = jax.jit(lambda tr, k: jinit_carry(jp, tr, k))(
        jtr, jax.random.PRNGKey(5))
    steps = 3 * T
    jcarry, jtrans, _ = jax.jit(lambda p, c, tr: jrollout(
        apply_fn, p, jp, tr, c, steps))(params, carry, jtr)

    net = make_policy("flat", A, OBS, dtype=torch.float32, device="cpu")
    net.load_state_dict(params_from_jax(jax.device_get(params)))
    actions = iter(torch.tensor(np.asarray(jtrans.action)))

    def replay(gen, logits):
        a = next(actions)
        return a, tdist.log_prob(logits, a)

    tcarry = init_carry(tp, ttr, torch.Generator().manual_seed(0))
    tcarry, trans, _ = rollout(net, tp, ttr, tcarry, steps,
                               sample_fn=replay)
    assert bool(np.asarray(jtrans.done).any()), "no episode ended"
    assert float(np.asarray(jtrans.reward).min()) < 0.0
    for f in ("action", "reward", "done", "mask", "env_steps_dt"):
        np.testing.assert_array_equal(getattr(trans, f).numpy(),
                                      np.asarray(getattr(jtrans, f)),
                                      err_msg=f)
    np.testing.assert_allclose(trans.obs.numpy(), np.asarray(jtrans.obs),
                               rtol=1e-6, atol=1e-7)
    # the per-tenant counts of the final states, and the reward of one
    # more step, bit for bit
    jcounts = jax.jit(jax.vmap(lambda s, t: jrewards.tenant_counts(s, t, 3)))(
        jcarry.env_state.sim, jtr)
    tcounts = trewards.tenant_counts(tcarry.env_state.sim, ttr, 3)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert tcounts.sum() > 0


def test_fair_reward_charges_concentration_more():
    """``tests/test_env.py``'s case: the same backlog on one tenant costs
    more than spread over four."""
    from rlgpuschedule_tpu_torch.traces.records import (JobRecord,
                                                        to_array_trace)
    params = tenv.EnvParams(sim=tcore.SimParams(N, G, J, K),
                            reward_kind="fair", n_tenants=4)
    noop = torch.tensor([params.n_actions - 1], dtype=torch.int32)
    rewards = []
    for tenants in ([0, 0, 0, 0], [0, 1, 2, 3]):
        jobs = [JobRecord(i, 0.0, 100.0, 1, tenant=t)
                for i, t in enumerate(tenants)]
        trace = tenv.stack_traces([to_array_trace(jobs, max_jobs=J)],
                                  params, device="cpu")
        state, _ = tenv.reset(params, trace)
        state, ts = tenv.step(params, state, trace, noop)
        state, ts = tenv.step(params, state, trace, noop)
        rewards.append(float(ts.reward))
    assert rewards[0] < rewards[1] < 0.0


# ---- ClippedRMSprop ----------------------------------------------------------

def _jax_policy(kind="flat", dtype=jnp.float32, seed=3):
    jnet = jmake_policy(kind, A, dtype=dtype)
    params = jax.device_get(jax.jit(jnet.init)(
        jax.random.PRNGKey(seed), np.zeros((1,) + OBS, np.float32),
        np.ones((1, A), bool)))
    return jnet, params


def _rms_state(opt_state):
    return next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByRmsState))
        if isinstance(s, optax.ScaleByRmsState))


def _port_net(params, dtype=torch.float32):
    net = make_policy("flat", A, OBS, dtype=dtype, device="cpu")
    net.load_state_dict(params_from_jax(params))
    return net


def _load_rms(opt, net, nu, step):
    """The port's RMSprop state from JAX's ``nu`` tree and step."""
    nus = params_from_jax(jax.device_get(nu))
    for name, p in net.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(step)),
                        "nu": nus[name].clone()}


def test_clipped_rmsprop_matches_optax_over_five_steps():
    _, params = _jax_policy()
    cfg = ja2c.A2CConfig()
    tx = ja2c.make_optimizer(cfg)
    rng = np.random.default_rng(6)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    net = _port_net(params)
    opt = ta2c.make_optimizer(ta2c.A2CConfig(), net.parameters())
    jp, state = params, tx.init(params)
    norms = []
    for scale in (1e-5, 2.0, 1e-5, 5.0, 1e-5):
        g = jax.tree.map(lambda p: (rng.normal(size=p.shape) * scale)
                         .astype(np.float32), params)
        norms.append(float(optax.global_norm(g)))
        upd, state = update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        for name, t in params_from_jax(g).items():
            dict(net.named_parameters())[name].grad = t
        opt.step()
    assert sum(n >= cfg.max_grad_norm for n in norms) == 2
    want = params_from_jax(jax.device_get(jp))
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    nu = params_from_jax(jax.device_get(_rms_state(state).nu))
    for name, p in net.named_parameters():
        np.testing.assert_allclose(opt.state[p]["nu"].numpy(),
                                   nu[name].numpy(), rtol=1e-6, atol=1e-12)
        assert int(opt.state[p]["step"]) == 5
    # torch's RMSprop divides by sqrt(nu) + eps: another update
    net2 = _port_net(params)
    torch_rms = torch.optim.RMSprop(net2.parameters(), lr=cfg.lr,
                                    alpha=0.99, eps=1e-5)
    g = params_from_jax(jax.tree.map(
        lambda p: np.full(p.shape, 1e-4, np.float32), params))
    for name, p in net2.named_parameters():
        p.grad = g[name]
    torch_rms.step()
    net3 = _port_net(params)
    opt3 = ta2c.make_optimizer(ta2c.A2CConfig(), net3.parameters())
    for name, p in net3.named_parameters():
        p.grad = g[name].clone()
    opt3.step()
    off = max(float((a - b).detach().abs().max()) for a, b in
              zip(net2.parameters(), net3.parameters()))
    assert off > 1e-4


# ---- the A2C learn step ------------------------------------------------------

def _batch(apply, params, rng, n_act=A):
    obs = rng.random((T, E) + OBS, dtype=np.float32)
    mask = rng.random((T, E, n_act)) < 0.6
    mask[..., -1] = True
    action = np.array([[rng.choice(np.flatnonzero(m)) for m in row]
                       for row in mask], np.int32)
    logits, _ = apply(params, obs, mask)
    lp = np.asarray(jdist.log_prob(logits, action))
    return JTransition(
        obs=obs, action=action,
        log_prob=(lp + rng.normal(0, 0.2, lp.shape)).astype(np.float32),
        value=rng.normal(size=(T, E)).astype(np.float32),
        reward=rng.normal(size=(T, E)).astype(np.float32),
        done=rng.random((T, E)) < 0.1, mask=mask,
        env_steps_dt=np.ones((T, E), np.float32))


def _jax_perms(key, n_epochs, b):
    perms = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        perms.append(torch.tensor(np.asarray(jax.random.permutation(sub, b))))
    return perms


def _to_torch(tr):
    return Transition(*(torch.tensor(np.asarray(x)) for x in tr))


def _jax_state(jnet, params, tx, reward_norm):
    if reward_norm:
        return jppo.NormTrainState.create(
            apply_fn=jnet.apply, params=params, tx=tx,
            reward_stats=jppo.init_reward_stats())
    return JTrainState.create(apply_fn=jnet.apply, params=params, tx=tx)


def _port_stats(jstats):
    return tppo.RewardNormState(*(torch.tensor(np.asarray(x))
                                  for x in jstats))


A2C_CASES = [("1x1", {}), ("2x2", dict(n_epochs=2, n_minibatches=2)),
             ("1x1-reward-norm", dict(reward_norm=True)),
             ("2x2-reward-norm", dict(n_epochs=2, n_minibatches=2,
                                      reward_norm=True)),
             ("1x1-bf16-advantages", dict(bf16_advantages=True))]


@pytest.mark.parametrize("geom", [c[1] for c in A2C_CASES],
                         ids=[c[0] for c in A2C_CASES])
def test_a2c_learn_step_matches_jax_from_a_mid_run_state(geom):
    jnet, params = _jax_policy()
    apply_fn = lambda p, o, m: jnet.apply(p, o, m)
    jcfg = ja2c.A2CConfig(n_steps=T, **geom)
    state0 = _jax_state(jnet, params, ja2c.make_optimizer(jcfg),
                        jcfg.reward_norm)
    learn = jax.jit(ja2c.make_learn_step(apply_fn, jcfg))
    apply = jax.jit(jnet.apply)
    rng = np.random.default_rng(7)
    tr_a = _batch(apply, params, rng)
    state1, _ = learn(state0, tr_a, rng.normal(size=E).astype(np.float32),
                      jax.random.PRNGKey(1))
    tr_b = _batch(apply, state1.params, rng)
    last = rng.normal(size=E).astype(np.float32)
    key = jax.random.PRNGKey(2)
    state2, jm = learn(state1, tr_b, last, key)

    net = _port_net(jax.device_get(state1.params))
    tcfg = ta2c.A2CConfig(n_steps=T, **geom)
    state = ta2c.make_train_state(net, tcfg)
    _load_rms(state.opt, net, _rms_state(state1.opt_state).nu,
              state1.step)
    if tcfg.reward_norm:
        state = state._replace(
            reward_stats=_port_stats(state1.reward_stats))
    n_ep = tcfg.n_epochs
    perms = (_jax_perms(key, n_ep, T * E) if tcfg.n_minibatches > 1
             else None)
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    state, m = ta2c.make_learn_step(tcfg)(state, _to_torch(tr_b),
                                          torch.tensor(last), gen, perms)
    assert torch.equal(gen.get_state(), before)     # perms or 1 x 1
    want = params_from_jax(jax.device_get(state2.params))
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
        assert p.dtype == torch.float32
    moved = max(float((want[n] - t).abs().max()) for n, t in
                params_from_jax(jax.device_get(state1.params)).items())
    assert moved > 1e-4, "the learn step did not move the parameters"
    assert list(m._fields) == list(ja2c.A2CMetrics._fields)
    for f in ja2c.A2CMetrics._fields:
        np.testing.assert_allclose(float(getattr(m, f)),
                                   float(getattr(jm, f)), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    assert int(next(iter(state.opt.state.values()))["step"]) == \
        int(state2.step)
    if tcfg.reward_norm:
        for got, ref in zip(state.reward_stats, state2.reward_stats):
            np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_a2c_experiment_trains_config_three_at_a_cut_size():
    """``tests/test_algos.py``'s case through the port's Experiment:
    three A2C iterations of ``a2c-pai-fair`` (cut to 4 nodes and 4
    envs) give finite metrics, f32 RMSprop state and 3 optimizer
    steps."""
    from rlgpuschedule_tpu_torch.configs import CONFIGS
    from rlgpuschedule_tpu_torch.experiment import Experiment
    cfg = dataclasses.replace(CONFIGS["a2c-pai-fair"], n_envs=4, n_nodes=4,
                              window_jobs=24)
    exp = Experiment.build(cfg, device="cpu")
    assert isinstance(exp.train_state.opt, tppo.ClippedRMSprop)
    assert exp.steps_per_iteration == 16 * 4
    out = exp.run(3, log_every=1)
    assert [r["iteration"] for r in out["history"]] == [0, 1, 2]
    for row in out["history"]:
        assert set(row) == {"iteration", *ta2c.A2CMetrics._fields}
        assert all(np.isfinite(v) for v in row.values())
    assert exp.step == 3
    for p in exp.net.parameters():
        assert exp.train_state.opt.state[p]["nu"].dtype == torch.float32


# ---- reward normalization ----------------------------------------------------

def test_welford_stats_match_jax_after_three_batches():
    rng = np.random.default_rng(3)
    batches = [rng.normal(loc=m, scale=s, size=(8, 4)).astype(np.float32)
               for m, s in ((2.0, 3.0), (-1.0, 0.5), (0.3, 1.7))]
    upd = jax.jit(jppo.update_reward_stats)
    js, ts = jppo.init_reward_stats(), tppo.init_reward_stats("cpu")
    for b in batches:
        js = upd(js, b)
        ts = tppo.update_reward_stats(ts, torch.from_numpy(b))
        for got, want in zip(ts, js):
            assert got.dtype == torch.float32 and got.shape == ()
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(ts.count) == 96.0
    np.testing.assert_allclose(float(tppo.reward_scale(ts)),
                               float(jax.jit(jppo.reward_scale)(js)),
                               rtol=1e-6)
    both = np.concatenate([b.ravel() for b in batches])
    np.testing.assert_allclose(float(ts.m2 / ts.count), np.var(both),
                               rtol=1e-4)


def test_reward_norm_threads_the_stats_through_a_ppo_learn_step():
    jnet, params = _jax_policy()
    apply_fn = lambda p, o, m: jnet.apply(p, o, m)
    jcfg = jppo.PPOConfig(n_steps=T, n_epochs=2, n_minibatches=2,
                          reward_norm=True)
    jstate = _jax_state(jnet, params, jppo.make_optimizer(jcfg), True)
    rng = np.random.default_rng(8)
    tr = _batch(jax.jit(jnet.apply), params, rng)
    last = rng.normal(size=E).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jstate2, jm = jax.jit(jppo.make_learn_step(apply_fn, jcfg))(
        jstate, tr, last, key)
    tcfg = tppo.PPOConfig(n_steps=T, n_epochs=2, n_minibatches=2,
                          reward_norm=True)
    net = _port_net(params)
    state = tppo.make_train_state(net, tcfg)
    assert float(state.reward_stats.count) == 0.0
    state, m = tppo.make_learn_step(tcfg)(
        state, _to_torch(tr), torch.tensor(last),
        perms=_jax_perms(key, 2, T * E))
    assert float(state.reward_stats.count) == T * E
    for got, want in zip(state.reward_stats, jstate2.reward_stats):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    want = params_from_jax(jax.device_get(jstate2.params))
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(m.v_loss), float(jm.v_loss),
                               rtol=1e-4, atol=1e-6)


# ---- V-trace -------------------------------------------------------------------

def _vtrace_inputs(seed, off_policy):
    rng = np.random.default_rng(seed)
    Tn, En = 32, 6
    r = rng.normal(size=(Tn, En)).astype(np.float32)
    v = rng.normal(size=(Tn, En)).astype(np.float32)
    d = rng.random((Tn, En)) < 0.15
    last = rng.normal(size=En).astype(np.float32)
    rho = (np.exp(rng.normal(0, 0.5, (Tn, En))).astype(np.float32)
           if off_policy else np.ones((Tn, En), np.float32))
    return r, v, d, last, rho


@pytest.mark.parametrize("rho_bar,c_bar", [(1.0, 1.0), (2.0, 0.7),
                                           (0.5, 1.5)])
def test_compute_vtrace_matches_jax_within_2_ulp(rho_bar, c_bar):
    r, v, d, last, rho = _vtrace_inputs(1, off_policy=True)
    assert (rho > max(rho_bar, c_bar)).any() and (rho < 1.0).any()
    ja, jr = jax.jit(jvtrace.compute_vtrace, static_argnums=(5, 6, 7, 8))(
        r, v, d, last, rho, 0.995, 0.95, rho_bar, c_bar)
    t = torch.from_numpy
    ta, tr = tvtrace.compute_vtrace(t(r), t(v), t(d), t(last), t(rho),
                                    0.995, 0.95, rho_bar, c_bar)
    assert ta.dtype == torch.float32
    assert _ulps(ta.numpy(), np.asarray(ja)).max() <= 2
    assert _ulps(tr.numpy(), np.asarray(jr)).max() <= 2


def test_importance_ratios_match_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(-1, 0.5, 64).astype(np.float32)
    b = rng.normal(-1, 0.5, 64).astype(np.float32)
    want = np.asarray(jax.jit(jvtrace.importance_ratios)(a, b))
    got = tvtrace.importance_ratios(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    same = tvtrace.importance_ratios(torch.from_numpy(a), torch.from_numpy(a))
    assert bool((same == 1.0).all())


def test_vtrace_at_unit_ratios_is_the_ports_gae_bit_for_bit():
    r, v, d, last, rho = _vtrace_inputs(4, off_policy=False)
    t = torch.from_numpy
    ga, gr = compute_gae(t(r), t(v), t(d), t(last), 0.995, 0.95)
    va, vr = tvtrace.compute_vtrace(t(r), t(v), t(d), t(last), t(rho),
                                    0.995, 0.95)
    assert torch.equal(ga, va) and torch.equal(gr, vr)


def test_ppo_vtrace_on_an_on_policy_rollout_is_the_gae_path():
    """JAX's premise (``tests/test_vtrace.py``) is that the one batched
    ``[T*E]`` forward of the recompute is row-equal to the rollout's
    per-step ``[E]`` forwards, so on-policy ratios are exactly 1 and the
    targets GAE's. Torch's CPU matmul does not hold it: rows of another
    batch size part by an ulp, so the ratios sit within 1e-6 of 1 (about
    8 ulp; the measured maximum is 1 ulp) and the targets within atol
    1e-5 of GAE's. Off-policy log-probs move both."""
    kw = dict(obs_kind="flat", horizon=6, reward_scale=1e4)
    tp = tenv.EnvParams(sim=tcore.SimParams(N, G, J, K), **kw)
    ttr = tenv.stack_traces(_pai_windows(n_tenants=2), tp, device="cpu")
    net = make_policy("flat", A, OBS, dtype=torch.float32, device="cpu")
    carry = init_carry(tp, ttr, torch.Generator().manual_seed(1))
    _, tr, last = rollout(net, tp, ttr, carry, T)
    base = tppo.PPOConfig(n_steps=T)
    state = tppo.make_train_state(net, base)
    _, adv_g, ret_g, rho_g = tppo.compute_advantages(base, state, tr, last)
    vcfg = dataclasses.replace(base, correction="vtrace")
    _, adv_v, ret_v, (rho_mean, rho_max) = tppo.compute_advantages(
        vcfg, state, tr, last)
    assert rho_g is None
    assert abs(float(rho_mean) - 1.0) <= 1e-6
    assert abs(float(rho_max) - 1.0) <= 1e-6
    np.testing.assert_allclose(adv_v.numpy(), adv_g.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ret_v.numpy(), ret_g.numpy(), rtol=0,
                               atol=1e-5)
    # with the recomputed log-probs as the behaviour's the ratios are 1
    # exactly, and the whole pipeline is GAE's bit for bit
    with torch.no_grad():
        logits, _ = net(tr.obs.reshape(T * E, -1),
                        tr.mask.reshape(T * E, -1))
        lp = tdist.log_prob(logits, tr.action.reshape(-1)).reshape(T, E)
    same = tr._replace(log_prob=lp)
    _, adv_s, ret_s, (m_s, x_s) = tppo.compute_advantages(vcfg, state,
                                                          same, last)
    assert float(m_s) == 1.0 and float(x_s) == 1.0
    assert torch.equal(adv_s, adv_g) and torch.equal(ret_s, ret_g)
    # ratios under the clips move the targets
    off = tr._replace(log_prob=tr.log_prob + 0.3)
    _, adv_o, _, (m_o, _) = tppo.compute_advantages(vcfg, state, off, last)
    assert float(m_o) < 1.0 and not torch.allclose(adv_o, adv_g)


# ---- bf16 ----------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["ppo", "a2c"])
def test_bf16_update_keeps_f32_state_and_tracks_jax(algo):
    jnet, params = _jax_policy()
    apply_fn = lambda p, o, m: jnet.apply(p, o, m)
    jlib, tlib = (jppo, tppo) if algo == "ppo" else (ja2c, ta2c)
    geom = dict(n_steps=T, n_epochs=2, n_minibatches=2, bf16_update=True)
    jcfg = (jppo.PPOConfig if algo == "ppo" else ja2c.A2CConfig)(**geom)
    tcfg = (tppo.PPOConfig if algo == "ppo" else ta2c.A2CConfig)(**geom)
    jstate = _jax_state(jnet, params, jlib.make_optimizer(jcfg), False)
    rng = np.random.default_rng(9)
    tr = _batch(jax.jit(jnet.apply), params, rng)
    last = rng.normal(size=E).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jstate2, jm = jax.jit(jlib.make_learn_step(apply_fn, jcfg))(
        jstate, tr, last, key)
    net = _port_net(params)
    state = tlib.make_train_state(net, tcfg)
    state, m = tlib.make_learn_step(tcfg)(
        state, _to_torch(tr), torch.tensor(last),
        perms=_jax_perms(key, 2, T * E))
    want = params_from_jax(jax.device_get(jstate2.params))
    moments = ("exp_avg", "exp_avg_sq") if algo == "ppo" else ("nu",)
    for name, p in net.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32
        for k in moments:
            assert state.opt.state[p][k].dtype == torch.float32
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-3, err_msg=name)
    assert all(np.isfinite(float(x)) for x in m)
    np.testing.assert_allclose(float(m.total_loss), float(jm.total_loss),
                               rtol=2e-2, atol=1e-3)


def test_bf16_advantages_dtype_and_band():
    jnet, params = _jax_policy()
    rng = np.random.default_rng(10)
    tr = _to_torch(_batch(jax.jit(jnet.apply), params, rng))
    last = torch.tensor(rng.normal(size=E).astype(np.float32))
    state = tppo.make_train_state(_port_net(params), tppo.PPOConfig())
    cfg = tppo.PPOConfig(n_steps=T)
    _, adv32, ret32, _ = tppo.compute_advantages(cfg, state, tr, last)
    cfg16 = dataclasses.replace(cfg, bf16_advantages=True)
    _, adv16, ret16, _ = tppo.compute_advantages(cfg16, state, tr, last)
    assert adv16.dtype == ret16.dtype == torch.bfloat16
    np.testing.assert_allclose(adv16.float().numpy(), adv32.numpy(),
                               atol=0.05, rtol=0.02)
    np.testing.assert_allclose(ret16.float().numpy(), ret32.numpy(),
                               atol=0.05, rtol=0.02)
