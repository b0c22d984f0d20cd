"""Parity of the port's PPO building blocks with the JAX package's.

Each test runs the JAX function (jitted, as its callers run it) and the
port's counterpart on the same numpy-seeded inputs, at f32:

- ``action_dist.log_prob``/``entropy`` on masked logits: within 1e-6;
  ``sample``: frequencies at a fixed seed within 5 binomial standard
  deviations of the softmax, and a masked action is never drawn;
- ``compute_gae``: within 2 f32 ulp, plus the closed forms of
  ``tests/test_algos.py``;
- ``ppo_loss``: value, aux terms and parameter gradients within 1e-5;
- ``run_minibatch_epochs`` fed JAX's permutations: equal minibatches;
- clip + Adam against optax for 3 steps from a JAX state with
  ``count > 0`` carried over by ``opt_state_from_jax``: within 1e-6;
- ``vec_step`` with and without a reset built once (``fresh``): every
  state field, mask, reward and done bit-identical to JAX's
  ``vec_step(..., fresh)`` across an episode boundary.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlgpuschedule_tpu.algos import action_dist as jdist
from rlgpuschedule_tpu.algos import ppo as jppo
from rlgpuschedule_tpu.algos import update as jupdate
from rlgpuschedule_tpu.algos.rollout import Transition as JTransition
from rlgpuschedule_tpu.algos.rollout import \
    validate_rollout_geometry as jvalidate_rollout
from rlgpuschedule_tpu.env import env as jenv
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu.ops import compute_gae as jgae
from rlgpuschedule_tpu.sim import core as jcore
from rlgpuschedule_tpu.traces import gen_poisson_trace as jpoisson
from rlgpuschedule_tpu_torch.algos import action_dist as tdist
from rlgpuschedule_tpu_torch.algos import ppo as tppo
from rlgpuschedule_tpu_torch.algos import update as tupdate
from rlgpuschedule_tpu_torch.algos.rollout import Transition
from rlgpuschedule_tpu_torch.algos.rollout import \
    validate_rollout_geometry as tvalidate_rollout
from rlgpuschedule_tpu_torch.env import env as tenv
from rlgpuschedule_tpu_torch.models import (make_policy, opt_state_from_jax,
                                            params_from_jax)
from rlgpuschedule_tpu_torch.ops import compute_gae
from rlgpuschedule_tpu_torch.sim import core as tcore


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the tensors are tiny: more threads only contend with other workers
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _ulps(x, y):
    """Distance in f32 ulps (equal values count 0)."""
    xi = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    yi = np.asarray(y, np.float32).view(np.int32).astype(np.int64)
    xi = np.where(xi < 0, np.int64(-2**31) - xi, xi)
    yi = np.where(yi < 0, np.int64(-2**31) - yi, yi)
    return np.where(x == y, 0, np.abs(xi - yi))


def _masked_logits(rng, b, a):
    logits = rng.normal(0, 2, (b, a)).astype(np.float32)
    mask = rng.random((b, a)) < 0.5
    mask[:, -1] = True
    mask[0] = False
    mask[0, 2] = True                  # one row with a single legal action
    return np.where(mask, logits, np.float32(-1e9)), mask


# ---- action distribution ---------------------------------------------------

def test_log_prob_and_entropy_match_jax():
    rng = np.random.default_rng(0)
    logits, mask = _masked_logits(rng, 64, 9)
    actions = np.array([rng.choice(np.flatnonzero(m)) for m in mask],
                       np.int32)
    jlp, jent = jax.jit(lambda lg, a: (jdist.log_prob(lg, a),
                                       jdist.entropy(lg)))(logits, actions)
    tl = torch.from_numpy(logits)
    tlp = tdist.log_prob(tl, torch.from_numpy(actions))
    tent = tdist.entropy(tl)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tent.numpy(), np.asarray(jent),
                               rtol=1e-6, atol=1e-6)
    assert float(tent[0]) == 0.0       # one legal action: no entropy


def test_sample_matches_the_softmax_and_never_draws_a_masked_action():
    logits = np.array([1.0, -1e9, 0.5, -0.3, -1e9, 2.0], np.float32)
    n = 200_000
    gen = torch.Generator().manual_seed(0)
    actions, logp = tdist.sample(gen, torch.from_numpy(logits).expand(n, -1))
    assert actions.dtype == torch.int32 and actions.shape == (n,)
    counts = np.bincount(actions.numpy(), minlength=logits.size)
    assert counts[1] == 0 and counts[4] == 0
    p = np.asarray(jax.nn.softmax(jnp.asarray(logits)), np.float64)
    sigma = np.sqrt(p * (1 - p) / n)
    np.testing.assert_array_less(np.abs(counts / n - p), 5 * sigma + 1e-12)
    np.testing.assert_allclose(
        logp.numpy(), np.log(p.astype(np.float32))[actions.numpy()],
        rtol=1e-6, atol=1e-6)
    # the same generator state draws the same actions
    again, _ = tdist.sample(torch.Generator().manual_seed(0),
                            torch.from_numpy(logits).expand(n, -1))
    assert torch.equal(actions, again)


# ---- GAE ---------------------------------------------------------------------

def test_compute_gae_matches_jax_within_2_ulp():
    rng = np.random.default_rng(1)
    T, E = 32, 6
    r = rng.normal(size=(T, E)).astype(np.float32)
    v = rng.normal(size=(T, E)).astype(np.float32)
    d = rng.random((T, E)) < 0.15
    last = rng.normal(size=E).astype(np.float32)
    ja, jr = jax.jit(jgae, static_argnums=(4, 5))(r, v, d, last, 0.995, 0.95)
    ta, tr = compute_gae(torch.from_numpy(r), torch.from_numpy(v),
                         torch.from_numpy(d), torch.from_numpy(last),
                         0.995, 0.95)
    assert ta.dtype == torch.float32
    assert _ulps(ta.numpy(), np.asarray(ja)).max() <= 2
    assert _ulps(tr.numpy(), np.asarray(jr)).max() <= 2


def _gae(r, v, d, last, gamma, lam):
    t = lambda x: torch.tensor(x, dtype=torch.float32)
    a, ret = compute_gae(t(r), t(v), t(d), t(last), gamma, lam)
    return a.numpy(), ret.numpy()


def test_compute_gae_closed_form():
    # hand-derived: gamma=0.9, lam=0.8 (tests/test_algos.py)
    v = [[0.5], [1.0], [1.5]]
    adv, ret = _gae([[1.0], [2.0], [3.0]], v, [[0.0]] * 3, [2.0], 0.9, 0.8)
    want = [4.80272, 4.726, 3.3]
    np.testing.assert_allclose(adv[:, 0], want, rtol=1e-6)
    np.testing.assert_allclose(ret[:, 0], np.array(v)[:, 0] + want,
                               rtol=1e-6)


def test_compute_gae_done_stops_bootstrap():
    adv, _ = _gae([[1.0], [2.0]], [[0.5], [1.0]], [[0.0], [1.0]], [99.0],
                  0.9, 0.8)
    # t=1 terminal: adv = 2 - 1 = 1; t=0: delta=1+0.9-0.5=1.4, +0.72*1
    np.testing.assert_allclose(adv[:, 0], [2.12, 1.0], rtol=1e-6)


def test_compute_gae_lambda1_is_mc_minus_v():
    rng = np.random.default_rng(0)
    r = rng.normal(size=(6, 2)).astype(np.float32)
    v = rng.normal(size=(6, 2)).astype(np.float32)
    last = rng.normal(size=(2,)).astype(np.float32)
    _, ret = _gae(r, v, np.zeros((6, 2)), last, 0.95, 1.0)
    want = np.zeros((6, 2))
    acc = last.astype(np.float64)
    for t in reversed(range(6)):
        acc = r[t] + 0.95 * acc
        want[t] = acc
    np.testing.assert_allclose(ret, want, rtol=1e-4)


# ---- PPO loss --------------------------------------------------------------

OBS_DIM, N_ACT, BATCH = 18, 4, 32


@pytest.fixture(scope="module")
def mlp():
    """A flat JAX actor-critic at f32, its numpy params and the port's
    copy of it."""
    jnet = jmake_policy("flat", N_ACT, dtype=jnp.float32)
    ex_obs = np.zeros((1, OBS_DIM), np.float32)
    ex_mask = np.ones((1, N_ACT), bool)
    params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(3),
                                               ex_obs, ex_mask))
    return jnet, params


def _port_net(params, kind="flat", shape=(OBS_DIM,), n_act=N_ACT):
    net = make_policy(kind, n_act, shape, dtype=torch.float32, device="cpu")
    net.load_state_dict(params_from_jax(params))
    return net


def _batch(rng, b, obs_shape, n_act, behaviour=None):
    """A numpy Transition of ``b`` rows: legal actions, a behaviour
    log-prob near the current policy's (so both clip branches occur)."""
    obs = rng.random((b,) + obs_shape, dtype=np.float32)
    mask = rng.random((b, n_act)) < 0.6
    mask[:, -1] = True
    action = np.array([rng.choice(np.flatnonzero(m)) for m in mask],
                      np.int32)
    lp = (rng.normal(-1.0, 0.3, b) if behaviour is None
          else behaviour(obs, mask, action) + rng.normal(0, 0.2, b))
    return JTransition(
        obs=obs, action=action, log_prob=lp.astype(np.float32),
        value=rng.normal(size=b).astype(np.float32),
        reward=rng.normal(size=b).astype(np.float32),
        done=rng.random(b) < 0.1, mask=mask,
        env_steps_dt=np.ones(b, np.float32))


def _to_torch(tr):
    return Transition(*(torch.from_numpy(np.asarray(x)) for x in tr))


def test_ppo_loss_value_and_grads_match_jax(mlp):
    jnet, params = mlp
    rng = np.random.default_rng(4)
    apply = jax.jit(jnet.apply)

    def behaviour(o, m, a):
        logits, _ = apply(params, o, m)
        return np.asarray(jdist.log_prob(logits, a))

    batch = _batch(rng, BATCH, (OBS_DIM,), N_ACT, behaviour)
    adv = rng.normal(size=BATCH).astype(np.float32)
    ret = rng.normal(size=BATCH).astype(np.float32)
    cfg = jppo.PPOConfig()
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b, a, r: jppo.ppo_loss(jnet.apply, p, b, a, r, cfg),
        has_aux=True))(params, batch, adv, ret)

    net = _port_net(params)
    loss, aux = tppo.ppo_loss(net, _to_torch(batch), torch.from_numpy(adv),
                              torch.from_numpy(ret), tppo.PPOConfig())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose([float(x) for x in aux],
                               [float(x) for x in jaux], rtol=1e-5,
                               atol=1e-5)
    assert 0.0 < float(aux[4]) < 1.0, "no ratio was clipped"
    want = params_from_jax(jax.device_get(jgrads))
    got = dict(net.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


# ---- the minibatch engine ----------------------------------------------------

def _jax_perms(key, n_epochs, b):
    """The permutations the JAX engine draws from ``key``: one split and
    one ``permutation`` per epoch."""
    perms = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(sub, b)))
    return perms


@pytest.mark.parametrize("n_epochs,n_mb,mb_size", [
    (3, 4, None), (2, 7, 4), (3, 1, None), (1, 1, None)])
def test_run_minibatch_epochs_gives_jax_minibatches(n_epochs, n_mb, mb_size):
    B = 16
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 3)).astype(np.float32)
    y = np.arange(B, dtype=np.int32)
    key = jax.random.PRNGKey(11)
    rec = lambda s, mb: (s + 1, mb)
    jcount, (jx, jy) = jax.jit(lambda k, data: jupdate.run_minibatch_epochs(
        rec, jnp.int32(0), data, k, n_epochs=n_epochs, n_minibatches=n_mb,
        minibatch_size=mb_size))(key, (x, y))
    perms = [torch.tensor(p) for p in _jax_perms(key, n_epochs, B)]
    seen = []

    def grad_step(state, mb):
        seen.append(mb)
        return state + 1, (mb[1].to(torch.float32).sum(),)

    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    count, stats = tupdate.run_minibatch_epochs(
        grad_step, 0, (torch.from_numpy(x), torch.from_numpy(y)),
        generator=gen, perms=perms, n_epochs=n_epochs, n_minibatches=n_mb,
        minibatch_size=mb_size)
    assert count == int(jcount)
    jy = np.asarray(jy).reshape(len(seen), -1)
    jx = np.asarray(jx).reshape(len(seen), -1, 3)
    for i, (tx, ty) in enumerate(seen):
        np.testing.assert_array_equal(ty.numpy(), jy[i])
        np.testing.assert_array_equal(tx.numpy(), jx[i])
    assert stats[0].shape == np.asarray(jcount).shape + (
        (n_epochs, len(seen) // n_epochs))
    # perms given, or a full-batch geometry: the generator is not touched
    assert torch.equal(gen.get_state(), before)


def test_run_minibatch_epochs_draws_from_the_generator():
    B, seen = 12, []
    data = (torch.arange(B),)
    step = lambda s, mb: (seen.append(mb[0]) or s, (mb[0].sum(),))
    tupdate.run_minibatch_epochs(step, None, data,
                                 generator=torch.Generator().manual_seed(1),
                                 n_epochs=2, n_minibatches=3)
    epochs = [torch.cat(seen[:3]), torch.cat(seen[3:])]
    for e in epochs:                       # each epoch is a permutation
        assert sorted(e.tolist()) == list(range(B))
    assert not torch.equal(epochs[0], epochs[1])
    with pytest.raises(ValueError, match="generator or perms"):
        tupdate.run_minibatch_epochs(step, None, data, n_epochs=1,
                                     n_minibatches=2)


@pytest.mark.parametrize("args", [
    (0, 4, None, 64), (1, 0, None, 64), (1, 4, None, 63), (1, 4, 0, 64),
    (1, 4, 48, 64), (2, 3, 16, 64), (1, 8, None, 64)])
def test_resolve_geometry_matches_jax(args):
    try:
        want = jupdate.resolve_geometry(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tupdate.resolve_geometry(*args)
        assert str(got.value).split()[0] == str(e).split()[0]
    else:
        assert tupdate.resolve_geometry(*args) == want


@pytest.mark.parametrize("n_steps,n_envs,n_devices", [
    (0, 4, 1), (8, 0, 1), (8, 6, 4), (8, 8, 4), (8, 3, 1)])
def test_geometry_validators_match_jax(n_steps, n_envs, n_devices):
    for jf, tf in ((lambda: jvalidate_rollout(n_steps, n_envs, n_devices),
                    lambda: tvalidate_rollout(n_steps, n_envs, n_devices)),
                   (lambda: jupdate.validate_update_geometry(
                        2, 4, None, n_steps=n_steps, n_envs=n_envs,
                        n_devices=n_devices),
                    lambda: tupdate.validate_update_geometry(
                        2, 4, None, n_steps=n_steps, n_envs=n_envs,
                        n_devices=n_devices))):
        try:
            want = jf()
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tf()
            assert str(got.value) == str(e)
        else:
            assert tf() == want


# ---- clip + Adam -------------------------------------------------------------

def _adam_state(opt_state):
    return next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def test_clip_and_adam_match_optax_from_a_mid_run_state(mlp):
    _, params = mlp
    cfg = jppo.PPOConfig()
    tx = jppo.make_optimizer(cfg)
    rng = np.random.default_rng(6)

    def grads(scale):
        return jax.tree.map(
            lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32),
            params)

    # two steps into the run: count == 2, moments non-zero
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    jp, state = params, tx.init(params)
    for scale in (1.0, 0.5):
        upd, state = update(grads(scale), state, jp)
        jp = optax.apply_updates(jp, upd)
    adam = _adam_state(state)
    assert int(adam.count) == 2

    def port(count):
        net = _port_net(jax.device_get(jp))
        opt = tppo.make_optimizer(tppo.PPOConfig(), net.parameters())
        opt.load_state_dict(opt_state_from_jax(
            jax.device_get(adam.mu), jax.device_get(adam.nu), count, net,
            opt))
        return net, opt

    net, opt = port(adam.count)
    steps = [grads(s) for s in (1e-3, 1.0, 3.0)]   # unclipped, clipped x2
    jnorms = []
    for g in steps:
        jnorms.append(float(optax.global_norm(g)))
        upd, state = update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        for name, t in params_from_jax(g).items():
            dict(net.named_parameters())[name].grad = t
        opt.step()
    assert jnorms[0] < cfg.max_grad_norm < min(jnorms[1:])
    want = params_from_jax(jax.device_get(jp))
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    # the count is what makes this test able to fail: restarting the
    # bias correction from 0 moves the parameters off optax's
    net0, opt0 = port(0)
    for g in steps:
        for name, t in params_from_jax(g).items():
            dict(net0.named_parameters())[name].grad = t
        opt0.step()
    off = max(float((p.detach() - want[n]).abs().max())
              for n, p in net0.named_parameters())
    assert off > 1e-5


def test_clip_by_global_norm_is_optax_rule():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    norm = tppo.clip_by_global_norm_(g, 5.0)       # at the bound: clipped
    assert float(norm) == 5.0
    assert g[0].tolist() == [3.0, 4.0]
    g = [torch.tensor([3.0, 4.0])]
    tppo.clip_by_global_norm_(g, 1.0)
    np.testing.assert_allclose(g[0].numpy(), [0.6, 0.8], rtol=1e-7)
    g = [torch.tensor([0.3, 0.4])]
    tppo.clip_by_global_norm_(g, 1.0)              # below: untouched
    assert g[0].tolist() == [pytest.approx(0.3), pytest.approx(0.4)]


@pytest.mark.parametrize("field,value", [
    ("bf16_update", True), ("reward_norm", True), ("bf16_advantages", True),
    ("correction", "vtrace")])
def test_ppo_config_refuses_unported_options(field, value):
    """The options once refused are taken as JAX takes them (and its
    learn step builds with them); an unknown correction is still
    refused with JAX's ValueError."""
    cfg = tppo.PPOConfig(**{field: value})
    assert getattr(cfg, field) == value
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jppo.PPOConfig(**{field: value}))
    assert callable(tppo.make_learn_step(cfg))
    with pytest.raises(ValueError) as want:
        jppo.PPOConfig(correction="bogus")
    with pytest.raises(ValueError) as got:
        tppo.PPOConfig(correction="bogus")
    assert str(got.value) == str(want.value)


# ---- vec_step with a reset built once ---------------------------------------

N, G, J, K, E = 4, 4, 16, 3, 4


def _integer_windows():
    out = []
    for s in range(E):
        tr = jpoisson(0.05, J, seed=s, max_jobs=J, mean_duration=300.0)
        out.append(dataclasses.replace(
            tr,
            submit=np.where(tr.valid, np.round(tr.submit),
                            np.inf).astype(np.float32),
            duration=np.maximum(np.round(tr.duration), 1.0
                                ).astype(np.float32)))
    return out


def _assert_same_step(jst, jts, tst, tts):
    for name in jst.sim._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jst.sim, name)),
                                      getattr(tst.sim, name).numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(jst.t), tst.t.numpy())
    for name in ("reward", "done", "action_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(jts, name)),
                                      getattr(tts, name).numpy(),
                                      err_msg=name)
    np.testing.assert_allclose(tts.obs.numpy(), np.asarray(jts.obs),
                               rtol=1e-6, atol=1e-7)


def test_vec_step_with_fresh_matches_jax_across_an_episode_end():
    kw = dict(obs_kind="flat", horizon=3, place_bonus=0.05,
              reward_scale=1e4, time_scale=600.0)
    jp = jenv.EnvParams(sim=jcore.SimParams(N, G, J, K), **kw)
    tp = tenv.EnvParams(sim=tcore.SimParams(N, G, J, K), **kw)
    wins = _integer_windows()
    jtr = jenv.stack_traces(wins, jp)
    ttr = tenv.stack_traces(wins, tp, device="cpu")
    jfresh = jax.jit(lambda tr: jenv.vec_reset(jp, tr))(jtr)
    jstep = jax.jit(lambda s, tr, a, f: jenv.vec_step(jp, s, tr, a, f))
    fresh = tenv.vec_reset(tp, ttr)
    jst, jts = jfresh
    (ast, ats), (bst, bts) = fresh, fresh
    rng = np.random.default_rng(8)
    ended = 0
    for i in range(7):
        m = np.asarray(jts.action_mask)
        a = np.array([rng.choice(np.flatnonzero(r)) for r in m], np.int32)
        jst, jts = jstep(jst, jtr, jnp.asarray(a), jfresh)
        ast, ats = tenv.vec_step(tp, ast, ttr, torch.from_numpy(a), fresh)
        bst, bts = tenv.vec_step(tp, bst, ttr, torch.from_numpy(a))
        _assert_same_step(jst, jts, ast, ats)
        # the two forms agree bit for bit, observations included
        for x, y in zip(jax.tree.leaves((ast, ats)),
                        jax.tree.leaves((bst, bts))):
            assert torch.equal(x, y), i
        ended += int(np.asarray(jts.done).sum())
    assert ended >= E                      # every cluster restarted
