"""Parity of the port's PBT population (config 5) with the JAX package's.

The host logic is numpy on both sides and must agree bit for bit:
``sample_hparams``, ``exploit_explore``'s decisions (dead members
included), the ``PBTController``'s cadence and its ``state_dict``, which
each package reads from the other. The member learn step with JAX's
weights, batch, permutations and hyperparameters agrees with JAX's
``make_member_learn_step`` within 1e-5; at the config's values it is the
plain PPO learn step (rtol 2e-5, JAX's own contract), and a 1e-2 learning
rate moves the parameters at least 10x more than 1e-5 does.
``gather_members`` copies parameters and Adam state with no aliasing.
``PopulationExperiment`` over the hierarchical members trains, exploits
and resumes bit for bit (3 iterations, a save, a restore and 2 more equal
5 straight, decision for decision), a member carried from a JAX
population replays JCT for JCT, and the CLIs train, evaluate and serve a
population at a cut config 5.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from rlgpuschedule_tpu.algos.ppo import PPOConfig as JPPOConfig
from rlgpuschedule_tpu.algos.rollout import init_carry as jinit_carry
from rlgpuschedule_tpu.algos.rollout import rollout as jrollout
from rlgpuschedule_tpu.env import env as jenv
from rlgpuschedule_tpu.env import hier as jhier
from rlgpuschedule_tpu.eval import replay as jreplay
from rlgpuschedule_tpu.models.hier import HierActorCritic as JHier
from rlgpuschedule_tpu.parallel import pbt as jpbt
from rlgpuschedule_tpu.parallel import population as jpop
from rlgpuschedule_tpu.sim import core as jcore
from rlgpuschedule_tpu.traces import gen_poisson_trace as jpoisson
from rlgpuschedule_tpu_torch import eval as teval
from rlgpuschedule_tpu_torch.algos import ppo as tppo
from rlgpuschedule_tpu_torch.algos.rollout import Transition
from rlgpuschedule_tpu_torch.algos.update import tree_map
from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
from rlgpuschedule_tpu_torch.configs import CONFIGS
from rlgpuschedule_tpu_torch.env import env as tenv
from rlgpuschedule_tpu_torch.experiment import (PopulationExperiment,
                                                build_hier_params)
from rlgpuschedule_tpu_torch.models import (make_hier_policy, member_params,
                                            params_from_jax)
from rlgpuschedule_tpu_torch.parallel import (HParams, MemberState,
                                              PBTConfig, PBTController,
                                              exploit_explore,
                                              gather_members, init_member,
                                              make_member_learn_step,
                                              make_member_optimizer,
                                              member_hparams, sample_hparams)

# the tensors here are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

GEOMETRY = dict(n_steps=8, n_epochs=2, n_minibatches=2)
TINY_HIER = dataclasses.replace(
    CONFIGS["hier-pbt-member"], n_nodes=4, gpus_per_node=4, n_pods=2,
    n_envs=4, window_jobs=16, queue_len=4, horizon=64,
    ppo=tppo.PPOConfig(n_steps=8, n_epochs=1, n_minibatches=2))
T, E = 8, 4


def _jax_hp(hp: HParams):
    return jpop.HParams(*(jnp.asarray(np.asarray(x, np.float32)) for x in hp))


def _assert_decisions_equal(a, b):
    assert len(a) == len(b)
    for d1, d2 in zip(a, b):
        np.testing.assert_array_equal(np.asarray(d1.src), np.asarray(d2.src))
        np.testing.assert_array_equal(np.asarray(d1.exploited),
                                      np.asarray(d2.exploited))
        for x, y in zip(d1.hparams, d2.hparams):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---- the host logic, bit for bit -------------------------------------------

@pytest.mark.parametrize("n,seed,spread", [(4, 0, 3.0), (8, 3, 3.0),
                                           (64, 7, 10.0), (1, 2, 3.0)])
def test_sample_hparams_match_jax(n, seed, spread):
    base = tppo.PPOConfig(lr=3e-4, ent_coef=0.01, clip_eps=0.2)
    got = sample_hparams(base, n, seed, spread)
    want = jpop.sample_hparams(JPPOConfig(), n, seed, spread)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (n,)
        np.testing.assert_array_equal(g, np.asarray(w))


FITNESS = {
    "ranked": np.arange(8.0),
    "normal": np.random.default_rng(1).normal(size=8),
    "one_dead": np.array([0.3, np.nan, 0.1, 0.2]),
    "more_dead_than_quota": np.array([np.nan, 0.5, np.inf, -np.inf, 0.2,
                                      np.nan]),
    "all_dead": np.array([np.nan, np.nan, np.nan]),
    "pair": np.array([1.0, -1.0]),
    "single": np.array([2.0]),
}


@pytest.mark.parametrize("case", sorted(FITNESS))
@pytest.mark.parametrize("frac", [0.25, 0.5])
def test_exploit_explore_decisions_match_jax(case, frac):
    fitness = FITNESS[case]
    n = len(fitness)
    hp = sample_hparams(tppo.PPOConfig(), n, seed=n)
    cfg = PBTConfig(exploit_frac=frac)
    jcfg = jpbt.PBTConfig(exploit_frac=frac)
    for seed in range(3):
        got = exploit_explore(np.random.default_rng(seed), fitness, hp, cfg)
        want = jpbt.exploit_explore(np.random.default_rng(seed), fitness,
                                    _jax_hp(hp), jcfg)
        _assert_decisions_equal([got], [want])
        for name in HParams._fields:
            lo, hi = jpop.HPARAM_BOUNDS[name]
            v = getattr(got.hparams, name)
            assert v.dtype == np.float32
            assert ((v >= np.float32(lo)) & (v <= np.float32(hi))).all()


def _tiny_members(n, seed=0):
    out = []
    for i in range(n):
        torch.manual_seed(seed + i)
        net = nn.Linear(3, 2)
        out.append(MemberState(net, make_member_optimizer(
            tppo.PPOConfig(), net.parameters())))
    return out


def _fitness_stream(n, k, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=n).astype(np.float32) for _ in range(k)]


def test_controller_cadence_and_state_dict_read_both_ways():
    n, ready = 4, 3
    hp = sample_hparams(tppo.PPOConfig(), n, seed=1)
    stream = _fitness_stream(n, 13)
    port = PBTController(n, PBTConfig(ready_iters=ready, seed=5))
    ref = jpbt.PBTController(n, jpbt.PBTConfig(ready_iters=ready, seed=5))
    members, states = _tiny_members(n), {"w": jnp.arange(float(n))}
    thp, jhp = hp, _jax_hp(hp)
    fired = []
    for i, f in enumerate(stream[:7]):
        port.record(torch.from_numpy(f))
        ref.record(jnp.asarray(f))
        a = port.maybe_update(i, members, thp)
        b = ref.maybe_update(i, states, jhp)
        assert (a is None) == (b is None), i
        if a is not None:
            members, thp, _ = a
            states, jhp, _ = b
            fired.append(i)
    assert fired == [2, 5]
    _assert_decisions_equal(port.history, ref.history)
    assert port._fitness_n == ref._fitness_n == 0
    np.testing.assert_array_equal(port.mean_fitness, ref.mean_fitness)
    # one pending record, then each package continues from the other's
    # JSON state
    port.record(torch.from_numpy(stream[7]))
    ref.record(jnp.asarray(stream[7]))
    sd_port = json.loads(json.dumps(port.state_dict()))
    sd_ref = json.loads(json.dumps(ref.state_dict()))
    assert sd_port == sd_ref
    port2 = PBTController(n, PBTConfig(ready_iters=ready, seed=99))
    ref2 = jpbt.PBTController(n, jpbt.PBTConfig(ready_iters=ready, seed=99))
    port2.load_state_dict(sd_ref)
    ref2.load_state_dict(sd_port)
    for i, f in enumerate(stream[8:], start=8):
        for ctrl in (port, port2):
            ctrl.record(torch.from_numpy(f))
            ctrl.maybe_update(i, _tiny_members(n), thp)
        for ctrl in (ref, ref2):
            ctrl.record(jnp.asarray(f))
            ctrl.maybe_update(i, states, jhp)
    for a in (port, port2):
        for b in (ref, ref2):
            _assert_decisions_equal(a.history, b.history)
    assert len(port.history) == 4


def test_gather_copies_params_and_adam_state_without_aliasing():
    members = _tiny_members(3)
    for k, m in enumerate(members):       # distinct Adam states, step 1
        m.opt.param_groups[0]["lr"] = 1e-2
        m.net.weight.grad = torch.full_like(m.net.weight, float(k + 1))
        m.net.bias.grad = torch.full_like(m.net.bias, -float(k + 1))
        m.opt.step()
    before = [({n: p.detach().clone() for n, p in m.net.named_parameters()},
               {id_: {k: v.clone() for k, v in s.items()}
                for id_, s in m.opt.state_dict()["state"].items()})
              for m in members]
    # members 0 and 1 swap (each must read the other as it was), 2 keeps
    out = gather_members(members, np.array([1, 0, 2]))
    for i, s in enumerate([1, 0, 2]):
        params, opt = before[s]
        for n, p in out[i].net.named_parameters():
            assert torch.equal(p, params[n])
        state = out[i].opt.state_dict()["state"]
        for id_, st in opt.items():
            for k, v in st.items():
                assert torch.equal(state[id_][k], v), (i, k)
    # no tensor is shared between members
    ptrs = [{t.data_ptr() for t in list(m.net.parameters())
             + [v for s in m.opt.state.values() for v in s.values()]}
            for m in out]
    assert not (ptrs[0] & ptrs[1]) and not (ptrs[0] & ptrs[2])
    # 0 <- 2: stepping the copy leaves its source unchanged
    out = gather_members(out, np.array([2, 1, 2]))
    src_w = out[2].net.weight.detach().clone()
    src_m = out[2].opt.state[out[2].net.weight]["exp_avg"].clone()
    out[0].net.weight.grad = torch.ones_like(out[0].net.weight)
    out[0].net.bias.grad = torch.ones_like(out[0].net.bias)
    out[0].opt.step()
    assert torch.equal(out[2].net.weight, src_w)
    assert torch.equal(out[2].opt.state[out[2].net.weight]["exp_avg"], src_m)
    assert not torch.equal(out[0].net.weight, src_w)
    assert int(out[0].opt.state[out[0].net.weight]["step"]) == 2


# ---- the member learn step -------------------------------------------------

@pytest.fixture(scope="module")
def world():
    """TINY_HIER's hierarchical env and f32 policy in both packages, and
    a JAX rollout of 8 steps on integer traces."""
    tp = build_hier_params(TINY_HIER)
    jp = jhier.HierParams(tp.n_pods, jcore.SimParams(
        tp.pod_sim.n_nodes, tp.pod_sim.gpus_per_node, tp.pod_sim.max_jobs,
        tp.pod_sim.queue_len), tp.time_scale, tp.reward_scale,
        tp.place_bonus, tp.horizon)
    wins = []
    for s in range(E):
        tr = jpoisson(0.04, 16, seed=20 + s, max_jobs=16,
                      mean_duration=300.0)
        wins.append(dataclasses.replace(
            tr, submit=np.where(tr.valid, np.round(tr.submit),
                                np.inf).astype(np.float32),
            duration=np.maximum(np.round(tr.duration), 1.0
                                ).astype(np.float32),
            gpus=np.minimum(tr.gpus, tp.pod_capacity).astype(np.int32)))
    jtr = jenv.stack_traces(wins, jp.pod_sim)
    ttr = tenv.stack_traces(wins, tp, device="cpu")
    jnet = JHier(n_top_actions=tp.n_top_actions,
                 n_pod_actions=tp.pod_sim.n_actions, dtype=jnp.float32)
    carry = jax.jit(lambda tr, k: jinit_carry(jp, tr, k))(
        jtr, jax.random.PRNGKey(3))
    init = jax.jit(jnet.init)
    stacked = jax.device_get(jpop.stack_members(
        [init(jax.random.PRNGKey(k), carry.obs, carry.mask)
         for k in (0, 1)]))
    params = member_params(stacked, 0)
    apply = lambda p, o, m: jnet.apply(p, o, m)
    # the traces go in as an argument, not a constant, so both parity
    # files' rollouts are one program in the persistent compile cache
    _, jtrans, jlast = jax.jit(
        lambda p, c, tr: jrollout(apply, p, jp, tr, c, T))(params, carry,
                                                             jtr)
    return dataclasses.make_dataclass("W", [
        "tp", "jp", "jtr", "ttr", "jnet", "apply", "stacked", "params",
        "jtrans", "jlast"])(tp, jp, jtr, ttr, jnet, apply, stacked, params,
                            jax.device_get(jtrans), np.asarray(jlast))


def _to_torch(tr):
    return tree_map(lambda x: torch.tensor(np.asarray(x)),
                    Transition(*tr))


def _jax_perms(key, n_epochs, b):
    perms = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        perms.append(torch.tensor(np.asarray(jax.random.permutation(sub, b))))
    return perms


def _port_member(world, params=None):
    net = make_hier_policy(world.tp, dtype=torch.float32, device="cpu")
    net.load_state_dict(params_from_jax(world.params if params is None
                                        else params))
    return init_member(net, tppo.PPOConfig(**GEOMETRY))


HP = HParams(lr=np.array([1e-3], np.float32),
             ent_coef=np.array([0.02], np.float32),
             clip_eps=np.array([0.15], np.float32))


def test_member_learn_step_matches_jax(world):
    jcfg = JPPOConfig(**GEOMETRY)
    jlearn = jax.jit(jpop.make_member_learn_step(world.apply, jcfg))
    jstate = jpop.MemberState(
        params=world.params,
        opt_state=jpop.make_member_tx(jcfg).init(world.params),
        step=jnp.int32(0))
    key = jax.random.PRNGKey(9)
    jstate2, jm = jlearn(jstate, world.jtrans, world.jlast, key,
                         jax.tree.map(lambda x: jnp.asarray(x[0]), HP))
    learn = make_member_learn_step(tppo.PPOConfig(**GEOMETRY))
    state, m = learn(_port_member(world), _to_torch(world.jtrans),
                     torch.tensor(world.jlast), None,
                     member_hparams(HP, 0, "cpu"),
                     perms=_jax_perms(key, 2, T * E))
    want = params_from_jax(jax.device_get(jstate2.params))
    moved = 0.0
    for name, p in state.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
        moved = max(moved, float((want[name] - params_from_jax(
            world.params)[name]).abs().max()))
    assert moved > 1e-3
    assert int(state.opt.state[next(state.net.parameters())]["step"]) == \
        int(jstate2.step) == 4
    for f in m._fields:
        np.testing.assert_allclose(float(getattr(m, f)),
                                   float(getattr(jm, f)), rtol=1e-4,
                                   atol=1e-6, err_msg=f)


def test_member_at_the_configs_values_is_the_plain_ppo_step(world):
    cfg = tppo.PPOConfig(**GEOMETRY)
    hp = HParams(*(np.array([v], np.float32)
                   for v in (cfg.lr, cfg.ent_coef, cfg.clip_eps)))
    tr, last = _to_torch(world.jtrans), torch.tensor(world.jlast)
    perms = _jax_perms(jax.random.PRNGKey(4), 2, T * E)
    member, _ = make_member_learn_step(cfg)(
        _port_member(world), tr, last, None, member_hparams(hp, 0, "cpu"),
        perms=perms)
    plain = _port_member(world)
    plain, _ = tppo.make_learn_step(cfg)(
        tppo.make_train_state(plain.net, cfg), tr, last, perms=perms)
    for (n, a), b in zip(member.net.named_parameters(),
                         plain.net.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-5, atol=1e-6, err_msg=n)


def test_learning_rate_scales_the_update(world):
    cfg = tppo.PPOConfig(**GEOMETRY)
    tr, last = _to_torch(world.jtrans), torch.tensor(world.jlast)
    perms = _jax_perms(jax.random.PRNGKey(4), 2, T * E)
    start = params_from_jax(world.params)
    moved = {}
    for lr in (1e-5, 1e-2):
        hp = HParams(np.array([lr], np.float32), np.array([0.01], np.float32),
                     np.array([0.2], np.float32))
        m, _ = make_member_learn_step(cfg)(
            _port_member(world), tr, last, None,
            member_hparams(hp, 0, "cpu"), perms=perms)
        moved[lr] = sum(float((p.detach() - start[n]).abs().sum())
                        for n, p in m.net.named_parameters())
    assert moved[1e-2] > 10 * moved[1e-5] > 0


def test_reward_norm_is_refused_in_jaxs_words():
    with pytest.raises(ValueError, match="MemberState carries no "
                                         "reward_stats"):
        make_member_learn_step(tppo.PPOConfig(reward_norm=True))


def test_a_jax_population_member_replays_jct_for_jct(world):
    params = member_params(world.stacked, 1)
    net = make_hier_policy(world.tp, dtype=torch.float32, device="cpu")
    net.load_state_dict(params_from_jax(params))
    member = jax.tree.map(lambda x: x[1], world.stacked)
    jres, jstate = jax.jit(lambda p: jreplay(
        world.apply, p, world.jp, world.jtr, return_states=True))(member)
    tres, tstate = teval.replay(net, world.tp, world.ttr, return_states=True)
    np.testing.assert_array_equal(np.asarray(jres.n_done),
                                  tres.n_done.numpy())
    np.testing.assert_array_equal(np.asarray(jres.steps), tres.steps.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.pods.finish).min(1),
                                  tstate.pods.finish.amin(1).numpy())
    np.testing.assert_allclose(tres.avg_jct.numpy(), np.asarray(jres.avg_jct),
                               rtol=1e-6)


# ---- PopulationExperiment --------------------------------------------------

def _build(n_pop=2, ready=2, seed=0, cfg=TINY_HIER):
    return PopulationExperiment.build(
        cfg, n_pop=n_pop, pbt_cfg=PBTConfig(ready_iters=ready, seed=seed),
        device="cpu")


def test_population_trains_and_exploits():
    pop = _build()
    with pytest.raises(ValueError, match="no recorded fitness"):
        pop.best_member()
    out = pop.run(4, log_every=1)
    assert out["pbt_events"] >= 1
    assert out["env_steps"] == 4 * 8 * 4 * 2        # iters * T * E * P
    assert len(out["final_fitness"]) == 2
    assert all(np.isfinite(out["final_fitness"]))
    for h in out["history"]:
        vals = [h[f"mean_reward_{p}"] for p in range(2)]
        assert all(isinstance(v, float) and np.isfinite(v) for v in vals)
        assert h["mean_reward_mean"] == pytest.approx(sum(vals) / 2)
    view = pop.member_eval_view()
    assert view.member == pop.best_member()
    with pytest.raises(ValueError, match="out of range"):
        pop.member_eval_view(2)


def test_an_exploited_member_holds_its_sources_weights():
    pop = _build(n_pop=4, ready=1, seed=1)
    pop.run(1)
    (decision,) = pop.controller.history
    assert decision.exploited.any()
    for i, s in enumerate(decision.src):
        if s == i:
            continue
        for a, b in zip(pop.members[i].net.parameters(),
                        pop.members[s].net.parameters()):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
        np.testing.assert_array_equal(pop.hparams.lr[i],
                                      decision.hparams.lr[i])


def test_population_resume_is_bit_for_bit(tmp_path):
    """3 iterations, a save, a restore into a fresh build and 2 more
    equal 5 straight: parameters, Adam state, carries, hyperparameters
    and every exploit decision (the checkpoint holds one pending fitness
    record, ready_iters=2)."""
    full = _build(n_pop=4, seed=3)
    full.run(5)
    first = _build(n_pop=4, seed=3)
    first.run(3)
    with Checkpointer(str(tmp_path / "ck")) as ck:
        first.save_checkpoint(ck)
        resumed = _build(n_pop=4, seed=3)
        meta = resumed.restore_checkpoint(ck)
    assert meta["pbt_events"] == len(resumed.controller.history) == 1
    resumed.run(2)
    _assert_decisions_equal(full.controller.history,
                            resumed.controller.history)
    assert len(full.controller.history) == 2
    for a, b in zip(full.hparams, resumed.hparams):
        np.testing.assert_array_equal(a, b)
    for m1, m2 in zip(full.members, resumed.members):
        for a, b in zip(m1.net.parameters(), m2.net.parameters()):
            assert torch.equal(a, b)
            s1, s2 = m1.opt.state[a], m2.opt.state[b]
            assert all(torch.equal(s1[k], s2[k]) for k in s1)
    for c1, c2 in zip(full.carries, resumed.carries):
        assert torch.equal(c1.env_state.pods.status, c2.env_state.pods.status)
        assert torch.equal(c1.generator.get_state(), c2.generator.get_state())
    assert resumed.iteration == full.iteration == 5


def test_population_build_refusals(tmp_path):
    """What the population still refuses, and the telemetry it now
    takes (one telemetered iteration: run_start, its iteration event
    with the flattened columns, run_end)."""
    from rlgpuschedule_tpu_torch.obs import RunTelemetry, read_events
    with pytest.raises(ValueError, match="trains PPO members"):
        PopulationExperiment.build(CONFIGS["a2c-pai-fair"], device="cpu")
    with pytest.raises(NotImplementedError, match="item 21"):
        PopulationExperiment.build(TINY_HIER, mesh=object(), device="cpu")
    pop = _build()
    with pytest.raises(ValueError, match="watchdog rollback needs a "
                                         "checkpoint store"):
        pop.run(1, watchdog=object())
    with RunTelemetry(str(tmp_path), alarms=True, device="cpu") as tel:
        pop.run(1, log_every=1, telemetry=tel)
    events = read_events(tel.bus.path)
    assert [e["kind"] for e in events] == ["run_start", "iteration",
                                           "run_end"]
    assert events[0]["loop"] == "population"
    assert {"total_loss_0", "total_loss_mean"} <= set(events[1]["metrics"])


# ---- the CLIs --------------------------------------------------------------

CUT = ["--config", "hier-pbt-member", "--device", "cpu"]
TRAIN = CUT + ["--pbt", "--n-pop", "2", "--pbt-ready", "2", "--n-steps",
               "8", "--n-epochs", "1", "--n-minibatches", "2"]


def test_train_evaluate_and_serve_a_population(tmp_path):
    from rlgpuschedule_tpu_torch import evaluate, train
    from rlgpuschedule_tpu_torch.serve import __main__ as serve
    d = str(tmp_path / "pbt")
    out = train.main(TRAIN + ["--iterations", "4", "--ckpt-dir", d,
                              "--log-every", "2", "--eval-every", "2",
                              "--eval-windows", "2", "--keep-best"])
    assert out["pbt_events"] == 2 and out["n_pop"] == 2
    assert out["env_steps"] == 4 * 8 * 4 * 2
    assert len(out["eval_history"]) == 2
    fittest = out["fittest_member"]
    report = evaluate.main(CUT + ["--pbt", "--n-pop", "2", "--ckpt-dir", d,
                                 "--no-random"])
    assert np.isfinite(report["policy"]) and report["policy_completion"] > 0
    named = evaluate.main(CUT + ["--pbt", "--n-pop", "2", "--ckpt-dir", d,
                                 "--no-random", "--member", str(fittest)])
    assert named["policy"] == report["policy"]
    assert named["tiresias"] == report["tiresias"]
    served = serve.main(CUT + ["--fleet", "2", "--ckpt-dir", d])
    assert served["repro"]["member"] == fittest
    resumed = train.main(TRAIN + ["--iterations", "2", "--ckpt-dir", d,
                                  "--resume", "--log-every", "1"])
    assert resumed["pbt_events"] == 3
    with pytest.raises(SystemExit, match="--n-pop 2"):
        evaluate.main(CUT + ["--pbt", "--n-pop", "3", "--ckpt-dir", d])


@pytest.mark.parametrize("module,argv,msg", [
    ("train", ["--fused-chunk", "2"], "interleaves host-side"),
    ("train", ["--n-pop", "0"], "--n-pop must be"),
    ("evaluate", ["--full-trace"], "full-trace evaluation supports flat"),
    ("evaluate", ["--percentiles"], "--baselines-only/--pbt"),
    ("evaluate", ["--eval-windows", "2"], "population views"),
    ("evaluate", ["--backlog-gate", "2"], "no single FIFO"),
])
def test_pbt_cli_refusals(module, argv, msg):
    from rlgpuschedule_tpu_torch import evaluate, train
    main = {"train": train.main, "evaluate": evaluate.main}[module]
    with pytest.raises(SystemExit, match=msg):
        main(CUT + ["--pbt"] + argv)


def test_member_needs_pbt_and_a2c_population_is_refused():
    from rlgpuschedule_tpu_torch import evaluate, train
    with pytest.raises(SystemExit, match="pass --pbt"):
        evaluate.main(CUT + ["--member", "1"])
    with pytest.raises(SystemExit, match="trains PPO members"):
        train.main(["--config", "a2c-pai-fair", "--pbt", "--device", "cpu"])
