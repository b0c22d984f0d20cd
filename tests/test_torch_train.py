"""Parity of the port's training path with the JAX package's, and smoke
tests of ``Experiment`` and the ``train`` CLI.

A small world (4 nodes x 4 GPUs, 16-job windows, queue 3, 8 steps x 4
envs, PPO at 4 epochs x 4 minibatches) goes through both packages:

- one learn step from a JAX ``TrainState`` taken mid-run (Adam count 16),
  on the same batch with JAX's own permutations: parameters within
  atol 1e-5 at f32 and metrics within rtol 1e-4, for a flat (MLP) and a
  grid (CNN) policy; and the same against JAX's ``dtype=bf16`` trainer
  (f32 parameters, bf16 trunk), at a bf16 band, with the trunk's
  outputs bf16 and every grad and Adam moment f32;
- a rollout that replays JAX's sampled actions across an episode end:
  mask, reward, done and the simulated ``dt`` bit-identical, the
  observations within the env tolerance of ``tests/test_torch_sim.py``
  (rtol 1e-6, atol 1e-7: tanh differs by an ulp between XLA and torch),
  log-probs and values within 1e-5; then the learn step on each side's
  own rollout, parameters within atol 1e-5 (the slice as a whole).
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
import optax
import pytest
import torch
from flax.training.train_state import TrainState
from torch.utils._python_dispatch import TorchDispatchMode

from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu import evaluate as jevaluate
from rlgpuschedule_tpu import train as jtrain
from rlgpuschedule_tpu.algos import action_dist as jdist
from rlgpuschedule_tpu.algos import ppo as jppo
from rlgpuschedule_tpu.algos.rollout import init_carry as jinit_carry
from rlgpuschedule_tpu.algos.rollout import rollout as jrollout
from rlgpuschedule_tpu.algos.rollout import Transition as JTransition
from rlgpuschedule_tpu.env import env as jenv
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu.sim import core as jcore
from rlgpuschedule_tpu.traces import gen_poisson_trace as jpoisson
from rlgpuschedule_tpu_torch import cli as tcli
from rlgpuschedule_tpu_torch import evaluate as tevaluate
from rlgpuschedule_tpu_torch import train as ttrain
from rlgpuschedule_tpu_torch.algos import action_dist as tdist
from rlgpuschedule_tpu_torch.algos import ppo as tppo
from rlgpuschedule_tpu_torch.algos.rollout import init_carry, rollout
from rlgpuschedule_tpu_torch.algos.rollout import Transition
from rlgpuschedule_tpu_torch.configs import CONFIGS
from rlgpuschedule_tpu_torch.env import env as tenv
from rlgpuschedule_tpu_torch.experiment import Experiment
from rlgpuschedule_tpu_torch.models import (make_policy, opt_state_from_jax,
                                            params_from_jax)
from rlgpuschedule_tpu_torch.sim import core as tcore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, G, J, K = 4, 4, 16, 3
A = K + 1
T, E = 8, 4
SHAPES = {"flat": (N + 4 * K + 2,), "grid": (N + K, G, 2)}
GEOMETRY = dict(n_steps=T, n_epochs=4, n_minibatches=4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the tensors are tiny: more threads only contend with other workers
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class World:
    """The JAX side of one policy kind and trunk dtype, jitted once for
    the module."""

    def __init__(self, kind, dtype="float32"):
        self.kind = kind
        self.dtype = dtype
        self.shape, self.n_actions = SHAPES[kind], A
        self.cfg = jppo.PPOConfig(**GEOMETRY)
        self.net = jmake_policy(kind, A, dtype=getattr(jnp, dtype))
        self.apply_fn = lambda p, o, m: self.net.apply(p, o, m)
        ex_obs = np.zeros((1,) + SHAPES[kind], np.float32)
        ex_mask = np.ones((1, A), bool)
        # make_train_state with the init jitted (eager Flax init runs op
        # by op and takes seconds)
        self.state = TrainState.create(
            apply_fn=self.net.apply,
            params=jax.jit(self.net.init)(jax.random.PRNGKey(0), ex_obs,
                                          ex_mask),
            tx=jppo.make_optimizer(self.cfg))
        self.learn = jax.jit(jppo.make_learn_step(self.apply_fn, self.cfg))
        self.apply = jax.jit(self.net.apply)

    def torch_net(self):
        return make_policy(self.kind, A, SHAPES[self.kind],
                           dtype=getattr(torch, self.dtype), device="cpu")


class PresetWorld(World):
    """The JAX side of a preset's policy at this module's small cluster:
    ``ppo-mlp-preempt`` (flat, R = 2 preempt slots) or
    ``gnn-gang-place`` (the GNN over a racked topology, P = 2). f32."""

    R = 2

    def __init__(self, name):
        from rlgpuschedule_tpu.env.obs import build_adjacency as jadj
        from rlgpuschedule_tpu_torch.env.obs import build_adjacency
        self.kind, self.dtype = name, "float32"
        self.cfg = jppo.PPOConfig(**GEOMETRY)
        self.adj = None
        if name == "gnn-gang-place":
            self.P, self.Rs = 2, 0
            self.shape = (N + K, 5)
            self.adj = build_adjacency(N, K, 2)
            self.n_actions = K * self.P + 1
            self.net = jmake_policy("graph", self.n_actions,
                                    n_cluster_nodes=N, queue_len=K,
                                    n_placements=self.P,
                                    dtype=jnp.float32)
            adj = jnp.asarray(jadj(N, K, 2))
            self.apply_fn = lambda p, o, m: self.net.apply(p, o, adj, m)
            init = jax.jit(lambda k, o, m: self.net.init(k, o, adj, m))
        else:
            self.P, self.Rs = 1, self.R
            self.shape = (N + 4 * K + 4 * self.R + 2,)
            self.n_actions = K + self.R + 1
            self.net = jmake_policy("flat", self.n_actions,
                                    dtype=jnp.float32)
            self.apply_fn = lambda p, o, m: self.net.apply(p, o, m)
            init = jax.jit(self.net.init)
        ex_obs = np.zeros((1,) + self.shape, np.float32)
        ex_mask = np.ones((1, self.n_actions), bool)
        self.state = TrainState.create(
            apply_fn=self.apply_fn,
            params=init(jax.random.PRNGKey(0), ex_obs, ex_mask),
            tx=jppo.make_optimizer(self.cfg))
        self.learn = jax.jit(jppo.make_learn_step(self.apply_fn, self.cfg))
        self.apply = jax.jit(self.apply_fn)

    def torch_net(self):
        kw = {}
        if self.adj is not None:
            kw = dict(adjacency=self.adj, n_cluster_nodes=N, queue_len=K,
                      n_placements=self.P)
        return make_policy("graph" if kw else "flat", self.n_actions,
                           self.shape, dtype=torch.float32, device="cpu",
                           **kw)


@pytest.fixture(scope="module")
def worlds():
    return {}


def _world(worlds, kind, dtype="float32"):
    if (kind, dtype) not in worlds:
        worlds[kind, dtype] = (World(kind, dtype) if kind in SHAPES
                               else PresetWorld(kind))
    return worlds[kind, dtype]


def _batch(world, params, rng):
    """A numpy Transition [T, E, ...] with legal actions and behaviour
    log-probs near the policy's (so some ratios clip)."""
    obs = rng.random((T, E) + world.shape, dtype=np.float32)
    mask = rng.random((T, E, world.n_actions)) < 0.6
    mask[..., -1] = True
    action = np.array([[rng.choice(np.flatnonzero(m)) for m in row]
                       for row in mask], np.int32)
    logits, _ = world.apply(params, obs, mask)
    lp = np.asarray(jdist.log_prob(logits, action))
    return JTransition(
        obs=obs, action=action,
        log_prob=(lp + rng.normal(0, 0.2, lp.shape)).astype(np.float32),
        value=rng.normal(size=(T, E)).astype(np.float32),
        reward=rng.normal(size=(T, E)).astype(np.float32),
        done=rng.random((T, E)) < 0.1, mask=mask,
        env_steps_dt=np.ones((T, E), np.float32))


def _jax_perms(key, n_epochs, b):
    """The permutations JAX's update engine draws from ``key``."""
    perms = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        perms.append(torch.tensor(np.asarray(jax.random.permutation(sub, b))))
    return perms


def _adam(opt_state):
    return next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _port_state(world, jstate):
    """The port's TrainState carrying a JAX TrainState's weights and
    Adam state."""
    net = world.torch_net()
    net.load_state_dict(params_from_jax(jax.device_get(jstate.params)))
    state = tppo.make_train_state(net, tppo.PPOConfig(**GEOMETRY))
    adam = jax.device_get(_adam(jstate.opt_state))
    state.opt.load_state_dict(opt_state_from_jax(adam.mu, adam.nu,
                                                 adam.count, net, state.opt))
    return state


def _to_torch(tr):
    return Transition(*(torch.tensor(np.asarray(x)) for x in tr))


def _assert_learned_alike(world, jstate, jmetrics, state, metrics,
                          param_atol=1e-5, metric_rtol=1e-4,
                          metric_atol=1e-6):
    want = params_from_jax(jax.device_get(jstate.params))
    moved = 0.0
    for name, p in state.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=param_atol, err_msg=name)
    for name, p in params_from_jax(jax.device_get(world.state.params)
                                   ).items():
        moved = max(moved, float((want[name] - p).abs().max()))
    assert moved > 1e-3, "the learn steps did not move the parameters"
    for f in jppo.PPOMetrics._fields:
        np.testing.assert_allclose(float(getattr(metrics, f)),
                                   float(getattr(jmetrics, f)),
                                   rtol=metric_rtol, atol=metric_atol,
                                   err_msg=f)


class _MatmulDtypes(TorchDispatchMode):
    """Records the operand dtypes and shapes of every matmul and
    convolution that autograd runs, forward and backward."""

    OPS = {"mm", "addmm", "bmm", "convolution", "convolution_backward"}

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.OPS:
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            self.calls.append((name, {t.dtype for t in ts},
                               {d for t in ts for d in t.shape}))
        return func(*args, **(kwargs or {}))


# (kind, trunk dtype, param atol, metric rtol, metric atol). At bf16 the
# band is set by rounding, not by the port: XLA's CPU backend does not
# round bf16 where torch does (a third of the trunk's outputs are
# bit-equal), so one step's grads differ by about 1.5e-2 relative and
# sixteen Adam steps apart by 0.35e-3 at most (grid); atol 1e-3 is a
# quarter of the step's largest movement (4e-3). Metrics take the bf16
# band of tests/test_torch_models.py (2e-2), atol 1e-4 for approx_kl.
LEARN_CASES = [("flat", "float32", 1e-5, 1e-4, 1e-6),
               ("grid", "float32", 1e-5, 1e-4, 1e-6),
               ("flat", "bfloat16", 1e-3, 2e-2, 1e-4),
               ("grid", "bfloat16", 1e-3, 2e-2, 1e-4)]


@pytest.mark.parametrize("kind,dtype,param_atol,metric_rtol,metric_atol",
                         LEARN_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in LEARN_CASES])
def test_learn_step_matches_jax_from_a_mid_run_state(
        worlds, kind, dtype, param_atol, metric_rtol, metric_atol):
    w = _world(worlds, kind, dtype)
    rng = np.random.default_rng(1)
    tr_a = _batch(w, w.state.params, rng)
    state1, _ = w.learn(w.state, tr_a, rng.normal(size=E).astype(np.float32),
                        jax.random.PRNGKey(1))
    assert int(_adam(state1.opt_state).count) == 16
    tr_b = _batch(w, state1.params, rng)
    last = rng.normal(size=E).astype(np.float32)
    key = jax.random.PRNGKey(2)
    state2, jm = w.learn(state1, tr_b, last, key)

    state = _port_state(w, state1)
    learn = tppo.make_learn_step(tppo.PPOConfig(**GEOMETRY))
    with _MatmulDtypes() as ops:
        state, m = learn(state, _to_torch(tr_b), torch.tensor(last),
                         perms=_jax_perms(key, 4, T * E))
    assert 0.0 < float(m.clip_frac) < 1.0
    _assert_learned_alike(w, state2, jm, state, m, param_atol, metric_rtol,
                          metric_atol)
    # f32 parameters, grads and Adam moments; the trunk's products,
    # forward and backward, in the trunk's dtype; the heads' in f32 (as
    # Flax with dtype=bf16 and optax). A head's product is the one with
    # an operand dimension of n_actions (policy) or 1 (value).
    trunk = getattr(torch, dtype)
    cnn = len(SHAPES[kind]) == 3    # image observations: the CNN trunk
    assert any(n == "convolution_backward" for n, _, _ in ops.calls) == cnn
    for name, dts, dims in ops.calls:
        head = name in ("mm", "addmm") and bool(dims & {A, 1})
        assert dts == {torch.float32 if head else trunk}, (name, dts, dims)
    assert sum(dts == {trunk} for _, dts, _ in ops.calls) > 16
    for p in state.net.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
        moments = state.opt.state[p]
        assert moments["exp_avg"].dtype == torch.float32
        assert moments["exp_avg_sq"].dtype == torch.float32


@pytest.mark.parametrize("name", ["ppo-mlp-preempt", "gnn-gang-place"])
def test_learn_step_matches_jax_for_the_preemptive_and_graph_presets(
        worlds, name):
    """The mid-run learn step of the f32 cases above for the two new
    presets' policies (the MLP over the preempt block, the GNN with its
    factored pack|spread heads): parameters within atol 1e-5, metrics
    within rtol 1e-4 / atol 1e-6, the Adam state carried from JAX."""
    w = _world(worlds, name)
    rng = np.random.default_rng(2)
    tr_a = _batch(w, w.state.params, rng)
    state1, _ = w.learn(w.state, tr_a, rng.normal(size=E).astype(np.float32),
                        jax.random.PRNGKey(1))
    tr_b = _batch(w, state1.params, rng)
    last = rng.normal(size=E).astype(np.float32)
    key = jax.random.PRNGKey(2)
    state2, jm = w.learn(state1, tr_b, last, key)
    state = _port_state(w, state1)
    learn = tppo.make_learn_step(tppo.PPOConfig(**GEOMETRY))
    state, m = learn(state, _to_torch(tr_b), torch.tensor(last),
                     perms=_jax_perms(key, 4, T * E))
    assert 0.0 < float(m.clip_frac) < 1.0
    _assert_learned_alike(w, state2, jm, state, m)


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


def test_rollout_replaying_jax_actions_then_learning_matches_jax(worlds):
    w = _world(worlds, "flat")
    kw = dict(obs_kind="flat", horizon=5, place_bonus=0.05,
              reward_scale=1e4, time_scale=600.0)
    jp = jenv.EnvParams(sim=jcore.SimParams(N, G, J, K), **kw)
    tp = tenv.EnvParams(sim=tcore.SimParams(N, G, J, K), **kw)
    wins = _integer_windows()
    jtr = jenv.stack_traces(wins, jp)
    ttr = tenv.stack_traces(wins, tp, device="cpu")
    carry = jax.jit(lambda tr, k: jinit_carry(jp, tr, k))(
        jtr, jax.random.PRNGKey(5))
    _, jtrans, jlast = jax.jit(lambda p, c, tr: jrollout(
        w.apply_fn, p, jp, tr, c, T))(w.state.params, carry, jtr)

    state = _port_state(w, w.state)
    actions = iter(torch.tensor(np.asarray(jtrans.action)))

    def replay(gen, logits):
        a = next(actions)
        return a, tdist.log_prob(logits, a)

    tcarry = init_carry(tp, ttr, torch.Generator().manual_seed(0))
    tcarry, trans, last = rollout(state.net, tp, ttr, tcarry, T,
                                           sample_fn=replay)
    assert bool(np.asarray(jtrans.done).any()), "no episode ended"
    for f in ("action", "reward", "done", "mask", "env_steps_dt"):
        np.testing.assert_array_equal(getattr(trans, f).numpy(),
                                      np.asarray(getattr(jtrans, f)),
                                      err_msg=f)
    np.testing.assert_allclose(trans.obs.numpy(), np.asarray(jtrans.obs),
                               rtol=1e-6, atol=1e-7)
    for got, want in ((trans.log_prob, jtrans.log_prob),
                      (trans.value, jtrans.value), (last, jlast)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert not trans.obs.requires_grad

    key = jax.random.PRNGKey(6)
    jstate, jm = w.learn(w.state, jtrans, jlast, key)
    learn = tppo.make_learn_step(tppo.PPOConfig(**GEOMETRY))
    state, m = learn(state, trans, last, perms=_jax_perms(key, 4, T * E))
    _assert_learned_alike(w, jstate, jm, state, m)


# ---- Experiment and the CLI ---------------------------------------------------

def _cut(name):
    cfg = CONFIGS[name]
    return dataclasses.replace(
        cfg, n_envs=2, ppo=dataclasses.replace(cfg.ppo, n_steps=8,
                                               n_epochs=2, n_minibatches=2))


@pytest.mark.parametrize("name", ["ppo-mlp-synth64", "ppo-cnn-philly512"])
def test_experiment_trains_and_logs_finite_metrics(name):
    exp = Experiment.build(_cut(name), device="cpu")
    before = [p.detach().clone() for p in exp.net.parameters()]
    logged = []
    out = exp.run(2, log_every=1, logger=lambda i, m: logged.append(i))
    assert exp.steps_per_iteration == 16
    assert out["env_steps"] == 32 and out["env_steps_per_sec"] > 0
    assert logged == [0, 1] and len(out["history"]) == 2
    for row in out["history"]:
        assert set(row) == {"iteration", *tppo.PPOMetrics._fields}
        assert all(math.isfinite(v) for v in row.values())
    assert any(not torch.equal(a, b.detach())
               for a, b in zip(before, exp.net.parameters()))
    assert exp.carry.obs.shape[0] == 2


@pytest.mark.parametrize("obs_kind", ["flat", "grid", "graph"])
def test_preemptive_action_space_trains_for_every_encoder(obs_kind):
    """``tests/test_experiment.py``'s case: ``ppo-mlp-preempt`` trains
    with each encoder family over the ``[K*P][R][no-op]`` layout (the
    graph one with pack|spread)."""
    cfg = dataclasses.replace(
        _cut("ppo-mlp-preempt"), obs_kind=obs_kind, n_nodes=4,
        gpus_per_node=4, window_jobs=16, queue_len=4,
        n_placements=2 if obs_kind == "graph" else 1)
    exp = Experiment.build(cfg, device="cpu")
    assert exp.env_params.n_actions == \
        cfg.queue_len * cfg.n_placements + cfg.preempt_len + 1
    assert exp.carry.mask.shape[-1] == exp.env_params.n_actions
    out = exp.run(2, log_every=1)
    assert all(math.isfinite(v) for h in out["history"] for v in h.values())


def test_train_cli_prints_finite_metrics_on_the_cpu():
    p = subprocess.run(
        [sys.executable, "-m", "rlgpuschedule_tpu_torch.train",
         "--config", "ppo-mlp-synth64", "--n-envs", "2", "--n-steps", "8",
         "--n-epochs", "1", "--n-minibatches", "2", "--iterations", "2",
         "--log-every", "1", "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    lines = [json.loads(x) for x in p.stdout.splitlines()]
    rows, summary = lines[:-1], lines[-1]
    assert [r["iteration"] for r in rows] == [0, 1]
    for r in rows:
        assert math.isfinite(r["total_loss"]) and r["entropy"] > 0
    assert summary["env_steps"] == 32 and summary["env_steps_per_sec"] > 0
    assert summary["device_name"] == "cpu"


def test_train_cli_refuses_a2c_with_the_slice_named():
    """Config 3 trains (``tests/test_torch_fused.py``), with the async
    engine too; what it still cannot take is refused with JAX's words:
    flight-log retraining and the V-trace correction (both go through
    PPO's V-trace pipeline)."""
    for argv, match in ((["--continual", "logs"],
                         "retrains through the V-trace-corrected PPO"),
                        (["--async", "--correction", "vtrace"],
                         "--correction selects the PPO advantage")):
        with pytest.raises(SystemExit, match=match):
            ttrain.main(["--config", "a2c-pai-fair", *argv, "--device",
                         "cpu"])


@pytest.mark.parametrize("argv", [
    ["--continual", "logs"], ["--async"], ["--mesh=auto"],
    ["--debug-nans"], ["--staleness-bound", "4"],
    ["--max-rollbacks", "2"]])
def test_train_cli_refuses_unported_flags_with_the_slice_named(argv):
    # --continual is ported: a log directory that does not exist is
    # refused as JAX refuses an empty log; --debug-nans is ported: with
    # --alarms (whose sync guard its per-op host read would trip on the
    # card) it is refused with the port's reason; --async and its flags
    # are ported: a queue of no slot and a bound without the engine are
    # refused with JAX's words
    match = {"--continual": "continual ingest refused: no verified shards",
             "--debug-nans": "--debug-nans reads every operation's output",
             "--async": "--queue-capacity must be >= 1",
             "--staleness-bound": "--staleness-bound configures the async "
                                  "engine; pass --async with it"
             }.get(argv[0], r"waits for .*item \d+")
    if argv[0] == "--debug-nans":
        argv = argv + ["--alarms", "--obs-dir", "unused"]
    if argv[0] == "--async":
        argv = argv + ["--queue-capacity", "0"]
    with pytest.raises(SystemExit, match=match):
        ttrain.main(argv + ["--device", "cpu"])


def test_every_jax_train_flag_is_taken_or_refused():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings
                if s.startswith("--") and s != "--help"}
    jax_flags = flags(jtrain.build_parser())
    taken = flags(ttrain.build_parser())
    assert jax_flags - taken == set(ttrain.UNPORTED_FLAGS)
    assert taken - jax_flags == {"--device"}


def test_train_cli_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--iterations", "1"])


def test_presets_mean_the_same_run_as_jax():
    for name, cfg in CONFIGS.items():
        ref = jconfigs.CONFIGS[name]
        assert (cfg.algo, cfg.iterations) == (ref.algo, ref.iterations)
        for f in dataclasses.fields(cfg.ppo):
            assert getattr(cfg.ppo, f.name) == getattr(ref.ppo, f.name), f


# config 1 cut to a few seconds on the CPU (tests/test_eval.py's world)
TINY = ["--config", "ppo-mlp-synth64", "--n-nodes", "4",
        "--gpus-per-node", "4", "--window-jobs", "12", "--queue-len", "4",
        "--horizon", "96", "--device", "cpu"]
TINY_TRAIN = TINY + ["--n-envs", "2", "--n-steps", "8", "--n-epochs", "1",
                     "--n-minibatches", "2"]


def _json_lines(out):
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def test_train_cli_eval_probe_and_report_on_the_cpu(capsys):
    summary = ttrain.main(TINY_TRAIN + ["--iterations", "2",
                                        "--log-every", "1",
                                        "--eval-every", "2", "--report"])
    out = capsys.readouterr()
    lines = _json_lines(out.out)
    probes = [r for r in lines if "eval_avg_jct" in r]
    assert [r["iteration"] for r in probes] == [1]
    for r in probes:
        assert set(r) >= {"eval_avg_jct", "eval_completion", "eval_fifo",
                          "eval_tiresias", "eval_vs_tiresias"}
        assert r["eval_vs_tiresias"] == pytest.approx(
            r["eval_avg_jct"] / r["eval_tiresias"])
    assert lines[-1] == json.loads(json.dumps(summary))
    assert summary["eval_history"] == probes
    rep = summary["jct_report"]
    assert set(rep) >= {"policy", "random", "fifo", "sjf", "srtf",
                        "tiresias", "vs_tiresias", "policy_completion"}
    assert rep["baseline_backend"] == "native"
    assert all(math.isfinite(rep[k]) for k in ("policy", "vs_tiresias"))
    assert "policy/tiresias ratio" in out.err


def test_train_eval_probe_holds_out_seed_plus_1000():
    """The probe's windows are those of a run seeded ``seed + 1000``,
    and its baselines equal the table on those windows: streaming ones
    by default, drained ones for a drain-curriculum config ('auto' =
    'drain' there, as in JAX) or with ``regime="drain"``."""
    from rlgpuschedule_tpu_torch import eval as teval
    from rlgpuschedule_tpu_torch import experiment as texp
    args = ttrain.build_parser().parse_args(TINY_TRAIN)
    cfg = ttrain.apply_overrides(CONFIGS["ppo-mlp-synth64"], args)
    exp = Experiment.build(cfg, device="cpu")
    for c, regime, drain in ((cfg, "auto", 0.0), (cfg, "drain", 1.0),
                             (dataclasses.replace(cfg, drain_frac=0.5),
                              "auto", 1.0),
                             (dataclasses.replace(cfg, drain_frac=0.5),
                              "stream", 0.0)):
        row = ttrain.make_eval_probe(c, exp, 3, None, regime)(0)
        held = dataclasses.replace(cfg, seed=1000, n_envs=3,
                                   drain_frac=drain)
        win = texp.make_env_windows(held, texp.load_source_trace(held))
        want = teval.baseline_jct_table(win, 4, 4,
                                        names=("fifo", "tiresias"))
        assert row["eval_fifo"] == want["fifo"], (regime, drain)
        assert row["eval_tiresias"] == want["tiresias"], (regime, drain)
    with pytest.raises(ValueError, match="unknown probe regime"):
        ttrain.make_eval_probe(cfg, exp, 3, None, regime="mixed")


@pytest.mark.parametrize("argv,match", [
    (["--keep-best"], "requires --eval-every"),
    (["--eval-probe", "stream"], "silent no-op"),
    (["--trace", "philly", "--trace-path",
      os.path.join(ROOT, "tests", "fixtures", "philly_small.csv"),
      "--source-jobs", "10"], "silent no-op"),
    (["--source-jobs", "0"], "must be positive"),
    (["--config", "nope"], "unknown config"),
])
def test_train_cli_refuses_what_jax_refuses(argv, match):
    with pytest.raises(SystemExit, match=match):
        ttrain.main(TINY_TRAIN + ["--iterations", "1"] + argv)


def test_train_cli_refuses_eval_seed_on_a_csv_trace(capsys):
    csv = os.path.join(ROOT, "tests", "fixtures", "philly_small.csv")
    argv = ["--trace", "philly", "--trace-path", csv, "--window-jobs", "2",
            "--n-nodes", "1", "--gpus-per-node", "8", "--n-envs", "2",
            "--n-steps", "4", "--n-minibatches", "1", "--n-epochs", "1",
            "--iterations", "1", "--eval-every", "1", "--device", "cpu"]
    with pytest.raises(SystemExit, match="no effect for csv"):
        ttrain.main(argv + ["--eval-seed", "3"])
    summary = ttrain.main(argv + ["--eval-windows", "2"])
    assert "on-distribution" in capsys.readouterr().err
    assert summary["eval_history"][0]["eval_completion"] == 1.0


def test_evaluate_cli_prints_the_table_and_one_json_line(capsys):
    report = tevaluate.main(TINY + ["--no-random", "--percentiles",
                                    "--eval-windows", "3"])
    out = capsys.readouterr()
    (line,) = _json_lines(out.out)
    assert "random" not in line
    assert set(line["percentiles"]) == {"policy", "fifo", "sjf", "srtf",
                                        "tiresias"}
    assert line["policy"] == report["policy"]
    assert line["device_name"] == "cpu"
    assert line["repro"]["n_nodes"] == 4 and line["repro"]["config"] == \
        "ppo-mlp-synth64"
    assert line["baseline_backend"] == "native"
    assert "untrained init weights" in out.err and "p99" in out.err


def test_evaluate_cli_baselines_only(capsys):
    report = tevaluate.main(TINY + ["--baselines-only"])
    (line,) = _json_lines(capsys.readouterr().out)
    assert set(report) == {"fifo", "sjf", "srtf", "tiresias"}
    assert {k: line[k] for k in report} == report
    assert "repro" in line


def test_evaluate_cli_gate_and_windows_match_the_library(capsys):
    from rlgpuschedule_tpu_torch import eval as teval
    from rlgpuschedule_tpu_torch import experiment as texp
    report = tevaluate.main(TINY + ["--backlog-gate", "3", "--no-random",
                                    "--eval-windows", "5"])
    args = tevaluate.build_parser().parse_args(TINY)
    cfg = dataclasses.replace(CONFIGS["ppo-mlp-synth64"],
                              **tcli.config_overrides(args))
    exp = Experiment.build(cfg, device="cpu")
    win = texp.make_env_windows(dataclasses.replace(cfg, n_envs=5),
                                exp.source)
    want = teval.jct_report(exp, windows=win, include_random=False,
                            backlog_gate=3)
    assert report["backlog_gate"] == 3
    for k in ("policy", "policy_completion", "fifo", "tiresias"):
        assert report[k] == want[k], k


@pytest.mark.parametrize("argv,match", [
    (["--backlog-gate", "-1"], ">= 0"),
    (["--baselines-only", "--percentiles"], "--percentiles"),
    (["--baselines-only", "--eval-windows", "2"], "--eval-windows"),
    (["--baselines-only", "--backlog-gate", "2"], "--backlog-gate"),
    (["--config", "nope"], "unknown config"),
    (["--no-stall-guard"], "PREEMPTIVE|preemptive"),
    (["--config", "ppo-mlp-preempt", "--baselines-only",
      "--no-stall-guard"], "PREEMPTIVE|preemptive"),
])
def test_evaluate_cli_refuses_what_jax_refuses(argv, match):
    with pytest.raises(SystemExit, match=match):
        tevaluate.main(TINY + argv)


# the observability flags are ported: alone, each is refused in the JAX
# CLI's words for the flow it needs
_EVALUATE_OBS_REFUSALS = {
    "--alarms": (["--alarms"], "configure the --matrix table"),
    "--obs-dir": (["--obs-dir", "x"],
                  "--obs-dir serves the --chaos and --matrix flows"),
    "--trace-spans": (["--trace-spans"],
                      "--trace-spans records spans on the chaos event bus"),
}


@pytest.mark.parametrize("flag", sorted({*tevaluate.UNPORTED_FLAGS,
                                         *_EVALUATE_OBS_REFUSALS}))
def test_evaluate_cli_refuses_unported_flags_with_the_slice_named(flag):
    argv, match = _EVALUATE_OBS_REFUSALS.get(flag, (
        [flag, "x"], r"waits for .*ROADMAP.md(, \"Deliberately "
                     r"unported\"| queue 1, (item \d+|next [23]))"))
    with pytest.raises(SystemExit, match=match):
        tevaluate.main(argv + ["--device", "cpu"])


def test_every_jax_evaluate_flag_is_taken_or_refused():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings
                if s.startswith("--") and s != "--help"}
    jax_flags = flags(jevaluate.build_parser())
    taken = flags(tevaluate.build_parser())
    assert jax_flags - taken == set(tevaluate.UNPORTED_FLAGS)
    assert taken - jax_flags == {"--device"}


def test_evaluate_cli_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tevaluate.main(["--baselines-only"])


def test_evaluate_cli_runs_as_a_module():
    p = subprocess.run(
        [sys.executable, "-m", "rlgpuschedule_tpu_torch.evaluate"] + TINY
        + ["--eval-windows", "2", "--max-steps", "64"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    (line,) = _json_lines(p.stdout)
    assert math.isfinite(line["policy"]) and 0 < line["policy_completion"]
    assert "tiresias" in p.stderr


# the two new presets cut as TINY cuts config 1
TINY_NEW = ["--n-nodes", "4", "--gpus-per-node", "4", "--window-jobs", "12",
            "--queue-len", "4", "--horizon", "96", "--device", "cpu"]


@pytest.mark.parametrize("name", ["ppo-mlp-preempt", "gnn-gang-place"])
def test_train_cli_trains_and_probes_the_new_presets(name, capsys):
    """Training of each new preset through the CLI, with the
    ``--eval-every`` probe (which replays with the stall guard on, as
    JAX's does) and the ``--report`` table."""
    summary = ttrain.main(["--config", name] + TINY_NEW + [
        "--n-envs", "2", "--n-steps", "8", "--n-epochs", "1",
        "--n-minibatches", "2", "--iterations", "2", "--log-every", "1",
        "--eval-every", "2", "--report"])
    lines = _json_lines(capsys.readouterr().out)
    rows = [r for r in lines if "total_loss" in r]
    assert [r["iteration"] for r in rows] == [0, 1]
    assert all(math.isfinite(r["total_loss"]) for r in rows)
    assert math.isfinite(summary["eval_history"][0]["eval_avg_jct"])
    rep = summary["jct_report"]
    assert math.isfinite(rep["policy"]) and rep["policy_completion"] > 0
    assert rep.get("stall_guard") is (True if name == "ppo-mlp-preempt"
                                      else None)


def test_train_cli_takes_the_graph_observation_for_any_preset(capsys):
    summary = ttrain.main(TINY_TRAIN + ["--obs-kind", "graph",
                                        "--iterations", "1"])
    assert summary["env_steps"] == 16 and summary["env_steps_per_sec"] > 0


def test_evaluate_cli_stall_guard_flags_on_a_preemptive_config(capsys):
    """The stall guard is on by default; ``--no-stall-guard`` replays the
    raw argmax, and the JSON line says which ran."""
    argv = ["--config", "ppo-mlp-preempt"] + TINY_NEW + [
        "--eval-windows", "2", "--no-random"]
    on = tevaluate.main(argv)
    off = tevaluate.main(argv + ["--no-stall-guard"])
    lines = _json_lines(capsys.readouterr().out)
    assert [x["stall_guard"] for x in lines] == [True, False]
    assert on["stall_guard"] is True and off["stall_guard"] is False


# ---- checkpoints, window streaming and the drain curriculum -----------------

def _train_cli(argv):
    p = subprocess.run(
        [sys.executable, "-m", "rlgpuschedule_tpu_torch.train"] + argv,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return _json_lines(p.stdout), p.stderr


def test_train_cli_resume_continues_the_run(tmp_path):
    """``train --ckpt-dir d`` for 2 iterations, then ``--resume`` for 2
    more, streaming with half the envs drained: the resumed process logs
    iterations 2 and 3 with the metrics of an uninterrupted 4-iteration
    run, bit for bit, and the step its checkpoint was saved under."""
    base = TINY_TRAIN + ["--log-every", "1", "--resample-every", "1",
                         "--drain-frac", "0.5", "--ckpt-every", "1"]
    whole, _ = _train_cli(base + ["--iterations", "4", "--ckpt-dir",
                                  str(tmp_path / "whole")])
    _train_cli(base + ["--iterations", "2", "--ckpt-dir",
                       str(tmp_path / "cut")])
    resumed, err = _train_cli(base + ["--iterations", "2", "--ckpt-dir",
                                      str(tmp_path / "cut"), "--resume"])
    assert "resumed from step 4 (iteration 1, window cursor 2)" in err
    rows = [r for r in resumed if "total_loss" in r]
    assert [r["iteration"] for r in rows] == [2, 3]
    assert rows == [r for r in whole if r.get("iteration") in (2, 3)
                    and "total_loss" in r]
    assert resumed[-1]["window_cursor"] == whole[-1]["window_cursor"] == 6
    from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
    # the default --ckpt-keep is 3; steps count Adam updates (1 x 2 per
    # iteration here)
    assert Checkpointer(str(tmp_path / "cut")).all_steps() == [4, 6, 8]
    assert Checkpointer(str(tmp_path / "whole")).all_steps() == [4, 6, 8]


def test_keep_best_keeps_its_bar_across_a_resume(tmp_path, capsys):
    from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
    d = str(tmp_path / "ck")
    argv = TINY_TRAIN + ["--eval-every", "1", "--eval-windows", "2",
                         "--keep-best", "--ckpt-dir", d, "--log-every", "0"]
    first = ttrain.main(argv + ["--iterations", "2"])
    best = Checkpointer(os.path.join(d, "best"))
    assert len(best.all_steps()) == 1
    bar = min(r["eval_avg_jct"] for r in first["eval_history"])
    assert best.read_meta()["eval_avg_jct"] == bar
    assert first["eval_history"][0]["eval_is_best"] == 1.0
    # lower the saved bar out of reach: a resumed run must read it back
    # and save nothing over it
    step = best.latest_step()
    state, meta = best.restore()
    best.save(step, state, dict(meta, eval_avg_jct=1.0), force=True)
    capsys.readouterr()
    again = ttrain.main(argv + ["--iterations", "2", "--resume"])
    assert "keep-best: prior best eval_avg_jct=1.0" in \
        capsys.readouterr().err
    assert [r["eval_is_best"] for r in again["eval_history"]] == [0.0, 0.0]
    assert best.all_steps() == [step]
    assert best.read_meta()["eval_avg_jct"] == 1.0
    # beside best/, the main store holds each call's last iteration
    # (--ckpt-every's default 50 is never reached)
    assert Checkpointer(d).all_steps() == [4, 8]


@pytest.mark.parametrize("argv", [
    ["--ckpt-keep", "2"], ["--ckpt-dir", "x", "--ckpt-keep", "0"],
    ["--keep-best", "--eval-every", "2"], ["--keep-best", "--ckpt-dir", "x"],
    ["--eval-probe", "drain"]])
def test_train_cli_exits_where_jax_exits(argv):
    """The checkpoint flags' refusals, word for word JAX's."""
    with pytest.raises(SystemExit) as want:
        jtrain.main(argv)
    with pytest.raises(SystemExit) as got:
        ttrain.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


def test_experiment_restore_refuses_another_config(tmp_path):
    from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
    cfg = _cut("ppo-mlp-synth64")
    exp = Experiment.build(cfg, device="cpu")
    exp.run(1)
    with Checkpointer(str(tmp_path / "ck")) as ck:
        exp.save_checkpoint(ck)
        other = Experiment.build(dataclasses.replace(cfg, queue_len=4),
                                 device="cpu")
        with pytest.raises(RuntimeError, match="size mismatch"):
            other.restore_checkpoint(ck, train=False)
