"""The evaluation slice as a whole: the port's ``jct_report`` against the
JAX package's, the backlog gate, the truncation guard and the random
control.

Configs 1 and 2 at a small size go through both packages'
``Experiment.build`` and ``jct_report``, the policy on both sides the
same f32 weights (the JAX init, converted with ``params_from_jax``) on
the same windows. The policy row, ``policy_completion``,
``policy_utilization``, the four baseline rows, ``vs_tiresias`` and the
p50/p90/p99 rows agree within rtol 1e-6; the random row does not enter
the comparison (the two random streams differ), only its checks here.
"""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu import eval as jeval
from rlgpuschedule_tpu import experiment as jexp
from rlgpuschedule_tpu.env import env as jenv
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu_torch import configs as tconfigs
from rlgpuschedule_tpu_torch import eval as teval
from rlgpuschedule_tpu_torch.env import env as tenv
from rlgpuschedule_tpu_torch.env.env import EnvParams, stack_traces
from rlgpuschedule_tpu_torch.experiment import Experiment
from rlgpuschedule_tpu_torch.models import make_policy, params_from_jax
from rlgpuschedule_tpu_torch.sim.core import SimParams
from rlgpuschedule_tpu_torch.traces import ArrayTrace
from torch_jax_builds import jax_view

# the tensors here are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

SMALL = {
    "ppo-mlp-synth64": dict(n_envs=3, n_nodes=4, gpus_per_node=4,
                            window_jobs=12, queue_len=4, horizon=96),
    "ppo-cnn-philly512": dict(n_envs=3, n_nodes=5, gpus_per_node=4,
                              window_jobs=16, queue_len=4, horizon=128),
}
PCTS = (50, 90, 99)
ROWS = ("policy", "policy_completion", "policy_utilization", "fifo", "sjf",
        "srtf", "tiresias", "vs_tiresias")


class Pair:
    """One small config built by both packages, the policy in f32 with
    the JAX init's weights on both sides."""

    def __init__(self, name):
        cfg_j = dataclasses.replace(jconfigs.CONFIGS[name], **SMALL[name])
        cfg_t = dataclasses.replace(tconfigs.CONFIGS[name], **SMALL[name])
        self.jexp = jax_view(cfg_j)
        self.params = self.jexp.train_state.params
        self.texp = Experiment.build(cfg_t, device="cpu")
        tp = self.texp.env_params
        net = make_policy(cfg_t.obs_kind, tp.n_actions, tp.obs_shape(),
                          dtype=torch.float32, device="cpu")
        net.load_state_dict(params_from_jax(self.params))
        self.texp.train_state = self.texp.train_state._replace(net=net)


@pytest.fixture(scope="module")
def pairs():
    return {}


def _pair(pairs, name) -> Pair:
    if name not in pairs:
        pairs[name] = Pair(name)
    return pairs[name]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_jct_report_matches_jax(pairs, name):
    p = _pair(pairs, name)
    want = jeval.jct_report(p.jexp, percentiles=PCTS)
    got = teval.jct_report(p.texp, percentiles=PCTS)
    assert want["policy_completion"] == 1.0
    for k in ROWS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    rows = ("policy", "fifo", "sjf", "srtf", "tiresias")
    for r in rows:
        assert set(got["percentiles"][r]) == {"p50", "p90", "p99"}
        for c, v in want["percentiles"][r].items():
            np.testing.assert_allclose(got["percentiles"][r][c], v,
                                       rtol=1e-6, err_msg=f"{r} {c}")
    assert got["baseline_backend"] == "native"
    assert np.isfinite(got["random"]) and got["random"] > 0
    assert got["policy_steps"] > 0
    assert set(got["wall_s"]) == {"policy_replay", "random_replay",
                                  "baselines"}
    text = teval.format_report(got)
    assert "tiresias" in text and "p99" in text and "native" in text


def test_baseline_table_matches_jax_on_held_out_windows(pairs):
    p = _pair(pairs, "ppo-mlp-synth64")
    # held-out windows at the pair's batch size: the JAX replay program
    # compiled for the pair serves them
    cfg_j, cfg_t = (dataclasses.replace(c, seed=1000)
                    for c in (p.jexp.cfg, p.texp.cfg))
    jwin = jexp.make_env_windows(cfg_j, jexp.load_source_trace(cfg_j))
    from rlgpuschedule_tpu_torch import experiment as texp
    twin = texp.make_env_windows(cfg_t, texp.load_source_trace(cfg_t))
    want = jeval.baseline_jct_table(jwin, 4, 4)
    got = teval.baseline_jct_table(twin, 4, 4)
    assert got == want
    # and through the report's windows= path, policy rows included
    jr = jeval.jct_report(p.jexp, windows=jwin, include_random=False)
    tr = teval.jct_report(p.texp, windows=twin, include_random=False)
    for k in ROWS:
        np.testing.assert_allclose(tr[k], jr[k], rtol=1e-6, err_msg=k)
    assert "random" not in tr


def test_truncated_replay_has_no_percentile_row(pairs):
    p = _pair(pairs, "ppo-mlp-synth64")
    report = teval.jct_report(p.texp, include_random=False,
                              baselines=("fifo",), percentiles=(50, 99),
                              max_steps=4)
    assert report["policy_completion"] < 1.0
    assert report["percentiles"]["policy"] == {}
    assert report["percentiles"]["fifo"]
    assert "—" in teval.format_report(report)
    assert "vs_tiresias" not in report


class FifoBackfill(nn.Module):
    """The gate's fall-through as a policy: the oldest fitting queue slot,
    the no-op only when nothing fits."""

    def __init__(self, env_params):
        super().__init__()
        self.prefs = teval._fifo_preferences(env_params,
                                             torch.device("cpu"))

    def forward(self, obs, mask):
        return (torch.where(mask, self.prefs, -1e9),
                torch.zeros(obs.shape[0]))


def test_gate_zero_is_plain_greedy(pairs):
    p = _pair(pairs, "ppo-cnn-philly512")
    e = p.texp
    plain, rp = teval.replay(e.net, e.env_params, e.traces, record=True)
    gated, rg = teval.replay(e.net, e.env_params, e.traces, record=True,
                             backlog_gate=0)
    torch.testing.assert_close(rp.actions, rg.actions, rtol=0, atol=0)
    for a, b in zip(plain, gated):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_always_on_gate_matches_jax_action_for_action(pairs, name):
    """A gate deeper than the job table always engages: the port's
    actions equal JAX's ``_gate_to_fifo`` at every step of every
    cluster (JAX's env driven by the port's actions), and the replay
    equals a FIFO-with-backfill policy's."""
    p = _pair(pairs, name)
    e = p.texp
    gate = e.env_params.sim.max_jobs + 1
    res, rec = teval.replay(e.net, e.env_params, e.traces, record=True,
                            backlog_gate=gate)
    acts = rec.actions.numpy()
    steps = res.steps.numpy()
    jp = p.jexp.env_params
    state, ts = jax.jit(lambda tr: jenv.vec_reset(jp, tr))(p.jexp.traces)
    step = jax.jit(jax.vmap(lambda s, tr, a: jenv.step(jp, s, tr, a)))
    decide = jax.jit(lambda st, o, m: jeval._gate_to_fifo(
        jp, st.sim.status, m,
        jnp.argmax(p.jexp.apply_fn(p.params, o, m)[0], -1), gate))
    for t in range(int(steps.max())):
        want = np.asarray(decide(state, ts.obs, ts.action_mask))
        live = t < steps
        np.testing.assert_array_equal(acts[t][live], want[live],
                                      err_msg=f"step {t}")
        state, ts = step(state, p.jexp.traces, jnp.asarray(acts[t]))
    fifo = teval.replay(FifoBackfill(e.env_params), e.env_params, e.traces)
    for a, b in zip(res, fifo):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_gate_mid_threshold_switches_within_episode():
    """The port's copy of the JAX gate test: four whole-cluster jobs run
    serially, so each finish time says who placed it. Newest-first
    (LIFO) alone finishes them at 50/200/150/100, FIFO at
    50/100/150/200, and gate 3 (FIFO while fewer than 3 are pending) at
    50/150/200/100: the gate hands control over and back mid-episode."""
    sim = SimParams(n_nodes=2, gpus_per_node=4, max_jobs=8, queue_len=4)
    params = EnvParams(sim=sim, obs_kind="flat", horizon=256)
    J = sim.max_jobs
    submit = np.full(J, np.inf, np.float32)
    submit[:4] = [0.0, 10.0, 20.0, 30.0]
    duration = np.full(J, 1.0, np.float32)
    duration[:4] = 50.0
    gpus = np.zeros(J, np.int32)
    gpus[:4] = sim.capacity
    tr = ArrayTrace(submit, duration, gpus, np.zeros(J, np.int32),
                    np.arange(J) < 4)
    traces = stack_traces([tr], params, "cpu")

    class NewestFirst(nn.Module):
        def forward(self, obs, mask):
            prefs = torch.arange(mask.shape[-1], dtype=torch.float32) + 2.0
            prefs[-1] = 0.5
            return torch.where(mask, prefs, -1e9), torch.zeros(obs.shape[0])

    def finishes(**kw):
        res, state = teval.replay(NewestFirst(), params, traces,
                                  return_states=True, **kw)
        assert int(res.n_done[0]) == 4
        return state.sim.finish[0, :4].numpy()

    np.testing.assert_allclose(finishes(), [50, 200, 150, 100], rtol=1e-5)
    np.testing.assert_allclose(finishes(backlog_gate=J + 1),
                               [50, 100, 150, 200], rtol=1e-5)
    np.testing.assert_allclose(finishes(backlog_gate=3),
                               [50, 150, 200, 100], rtol=1e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(policy="random", backlog_gate=2), "LEARNED|learned"),
    (dict(backlog_gate=-1), ">= 0"),
    (dict(policy="sampled"), "unknown replay policy"),
])
def test_replay_refuses_like_jax(pairs, kw, match):
    e = _pair(pairs, "ppo-mlp-synth64").texp
    with pytest.raises(ValueError, match=match):
        teval.replay(e.net, e.env_params, e.traces, **kw)
    jkw = dict(kw)
    if "policy" in jkw and jkw["policy"] == "random":
        jkw["key"] = jax.random.PRNGKey(0)
    j = _pair(pairs, "ppo-mlp-synth64").jexp
    with pytest.raises(ValueError, match=match):
        jeval.replay(j.apply_fn, j.train_state.params, j.env_params,
                     j.traces, **jkw)


def _random_replay(e, seed):
    gen = torch.Generator().manual_seed(seed)
    return teval.replay(None, e.env_params, e.traces, policy="random",
                        generator=gen, record=True)


def test_random_control_is_deterministic_and_legal(pairs):
    e = _pair(pairs, "ppo-cnn-philly512").texp
    res, rec = _random_replay(e, 1)
    res2, rec2 = _random_replay(e, 1)
    torch.testing.assert_close(rec.actions, rec2.actions, rtol=0, atol=0)
    for a, b in zip(res, res2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _, rec3 = _random_replay(e, 2)
    assert not torch.equal(rec.actions, rec3.actions)
    # drive the env with the recorded actions: each one is legal under
    # the mask of the state it was taken in
    steps = res.steps
    with torch.inference_mode():
        state, ts = tenv.reset(e.env_params, e.traces)
        for t in range(int(steps.max())):
            a = rec.actions[t]
            legal = ts.action_mask.gather(1, a.long()[:, None])[:, 0]
            assert bool(legal[t < steps].all()), f"step {t}"
            state, ts = tenv.step(e.env_params, state, e.traces, a)
    assert (res.n_done == res.n_valid).all()


def test_random_actions_are_uniform_over_the_legal_set():
    """A frequency test (the port's stream is not JAX's): 20,000 draws
    on each of four masks; every draw legal, and every legal action's
    count within 5 standard deviations of uniform."""
    masks = torch.tensor([[1, 1, 1, 1, 1, 1],
                          [1, 0, 0, 1, 0, 1],
                          [0, 0, 0, 0, 0, 1],
                          [0, 1, 1, 0, 1, 1]], dtype=torch.bool)
    n = 20_000
    gen = torch.Generator().manual_seed(7)
    counts = torch.zeros(masks.shape, dtype=torch.int64)
    for _ in range(n // 500):
        a, logits = teval._random_actions(gen, masks.repeat(500, 1))
        assert logits.dtype == torch.float32
        a = a.long().view(500, 4)
        for r in range(4):
            counts[r] += torch.bincount(a[:, r], minlength=6)
    assert int(counts[~masks].sum()) == 0
    for r in range(4):
        k = int(masks[r].sum())
        mean, sd = n / k, (n * (1 / k) * (1 - 1 / k)) ** 0.5
        got = counts[r][masks[r]].double()
        assert float((got - mean).abs().max()) <= 5 * sd + 1e-9, (r, got)


# ---- the preemptive and graph presets ----------------------------------------

NEW = {
    # a cycling policy spends up to stall_threshold (12) zero-dt steps
    # between events: about 1,300 steps for 32 jobs
    "ppo-mlp-preempt": dict(n_nodes=4, gpus_per_node=4, window_jobs=32,
                            queue_len=4, horizon=2048),
    "gnn-gang-place": dict(n_nodes=8, gpus_per_node=4, window_jobs=32,
                           queue_len=4, horizon=256),
}
GUARD_E = 4
F32_TOL = 1e-5    # f32 logits agree this closely (tests/test_torch_gnn.py)


def _new_pair(name):
    """The preset's small windows and one JAX-initialised f32 policy in
    both packages, the policy heads scaled by 100 (as in
    ``tests/test_torch_models.py``). The preemptive policy is also made
    to cycle: a bias of +20 on preempting running slot 0 and +10 on
    placing queue slot 0 make place<->preempt its argmax whenever both
    are legal, so the stall guard has to engage."""
    from rlgpuschedule_tpu.env.obs import build_adjacency as jadj
    from rlgpuschedule_tpu.serve.fleet import fleet_windows as jfleet
    from rlgpuschedule_tpu_torch.experiment import build_env_params as \
        texp_build_env_params
    from rlgpuschedule_tpu_torch.experiment import build_policy
    from rlgpuschedule_tpu_torch.serve.fleet import fleet_windows
    cfg_j = dataclasses.replace(jconfigs.CONFIGS[name], **NEW[name])
    cfg_t = dataclasses.replace(tconfigs.CONFIGS[name], **NEW[name])
    _, jtraces = jfleet(cfg_j, GUARD_E)
    _, ttraces = fleet_windows(cfg_t, GUARD_E, device="cpu")
    jp = jexp.build_env_params(cfg_j)
    _, ts0 = jax.jit(lambda tr: jenv.vec_reset(jp, tr))(jtraces)
    net = jmake_policy(cfg_j.obs_kind, jp.n_actions,
                       n_cluster_nodes=cfg_j.n_nodes,
                       queue_len=cfg_j.queue_len,
                       n_placements=cfg_j.n_placements,
                       preempt_len=cfg_j.preempt_len, dtype=jnp.float32)
    if cfg_j.obs_kind == "graph":
        adj = jnp.asarray(jadj(cfg_j.n_nodes, cfg_j.queue_len,
                               cfg_j.nodes_per_rack, cfg_j.preempt_len))
        apply_fn = lambda p, o, m: net.apply(p, o, adj, m)
        init = jax.jit(lambda k, o, m: net.init(k, o, adj, m))
    else:
        apply_fn = lambda p, o, m: net.apply(p, o, m)
        init = jax.jit(net.init)
    params = jax.device_get(init(jax.random.PRNGKey(0), ts0.obs,
                                 ts0.action_mask))
    tree = params["params"]
    for h in ("policy", "slot_policy", "preempt_policy", "noop_policy"):
        if h in tree:
            tree[h]["kernel"] = np.asarray(tree[h]["kernel"]) * 100.0
    if cfg_j.preempt_len:
        kp = cfg_j.queue_len * cfg_j.n_placements
        bias = np.array(tree["policy"]["bias"])
        bias[kp], bias[0] = 20.0, 10.0
        tree["policy"]["bias"] = bias
    tp = texp_build_env_params(cfg_t)
    policy = build_policy(cfg_t, tp, dtype=torch.float32, device="cpu")
    policy.load_state_dict(params_from_jax(params))
    return (apply_fn, params, jp, jtraces), (policy, tp, ttraces)


def _job_jcts(finish, submit, valid):
    finish = np.asarray(finish, np.float64)
    done = np.asarray(valid) & np.isfinite(finish)
    return np.where(done, finish - np.asarray(submit, np.float64), np.nan)


@pytest.mark.parametrize("name", sorted(NEW))
def test_guarded_greedy_replay_matches_jax_job_for_job(name):
    """Greedy replay with the stall guard on, f32, the same weights: per
    cluster ``steps`` and ``n_done`` equal and every per-job JCT equal
    to JAX's. The port's top-two logit margin is checked at every step a
    cluster takes: where it exceeds twice the f32 logit tolerance the
    two packages cannot choose differently. A cluster with a narrower
    margin somewhere is compared no further (the margin rule of
    ``tests/test_torch_replay.py``); at least half must run in step to
    the end. On the preemptive preset the guard must have engaged and
    every job must finish."""
    (apply_fn, params, jp, jtraces), (policy, tp, ttraces) = _new_pair(name)
    # every cluster is done or cut by the horizon within it
    max_steps = NEW[name]["horizon"]
    jres, jstate = jeval.replay(apply_fn, params, jp, jtraces, max_steps,
                                return_states=True, stall_guard=True)
    tres, tstate, rec = teval.replay(policy, tp, ttraces, max_steps,
                                     record=True, return_states=True)
    steps = tres.steps.numpy()
    margin = rec.margin.numpy()
    clear = [e for e in range(GUARD_E)
             if (margin[:steps[e], e] > 2 * F32_TOL).all()]
    assert len(clear) >= GUARD_E // 2, f"only clusters {clear} clear"
    for k in ("steps", "n_done", "n_valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jres, k))[clear],
                                      getattr(tres, k).numpy()[clear],
                                      err_msg=k)
    want = _job_jcts(jstate.sim.finish, jtraces.submit, jtraces.valid)
    got = _job_jcts(tstate.sim.finish.numpy(), ttraces.submit.numpy(),
                    ttraces.valid.numpy())
    np.testing.assert_array_equal(got[clear], want[clear])
    assert (tres.n_done == tres.n_valid).all()
    if tp.sim.preempt_len:
        assert int(rec.gated.sum()) > 0, "the stall guard never engaged"
        # unguarded, the first place<->preempt cycle never ends
        unguarded = teval.replay(policy, tp, ttraces, 512,
                                 stall_guard=False)
        assert int(unguarded.n_done.sum()) < int(unguarded.n_valid.sum())
    else:
        assert not rec.gated.any()


def test_jct_report_records_the_stall_guard_where_it_can_engage():
    """``stall_guard`` is in the report of a preemptive config (guarded
    and unguarded rows come from different schedulers) and absent
    elsewhere, as in JAX."""
    cut = dict(n_envs=2, n_nodes=4, gpus_per_node=4, window_jobs=12,
               queue_len=4, horizon=96)
    got = {}
    for name in ("ppo-mlp-preempt", "ppo-mlp-synth64"):
        cfg = dataclasses.replace(tconfigs.CONFIGS[name], **cut)
        exp = Experiment.build(cfg, device="cpu")
        for guard in (True, False):
            got[name, guard] = teval.jct_report(
                exp, include_random=False, baselines=("fifo",),
                stall_guard=guard)
    assert got["ppo-mlp-preempt", True]["stall_guard"] is True
    assert got["ppo-mlp-preempt", False]["stall_guard"] is False
    assert "stall_guard" not in got["ppo-mlp-synth64", True]
    assert got["ppo-mlp-synth64", True]["policy"] == \
        got["ppo-mlp-synth64", False]["policy"]


# ---- evaluate --ckpt-dir, --drain-frac and --full-trace ---------------------

# config 1 cut to a few seconds on the CPU, as the train tests cut it
CUT = dict(n_envs=2, n_nodes=4, gpus_per_node=4, window_jobs=12,
           queue_len=4, horizon=96)
CUT_FLAGS = ["--config", "ppo-mlp-synth64", "--n-envs", "2", "--n-nodes",
             "4", "--gpus-per-node", "4", "--window-jobs", "12",
             "--queue-len", "4", "--horizon", "96"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A cut config-1 run trained 3 iterations on the drain curriculum,
    a checkpoint after each (2 kept)."""
    from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
    cfg = dataclasses.replace(
        tconfigs.CONFIGS["ppo-mlp-synth64"], **CUT, drain_frac=1.0,
        ppo=dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"].ppo,
                                n_steps=8, n_epochs=1, n_minibatches=2))
    d = str(tmp_path_factory.mktemp("trained") / "ck")
    exp = Experiment.build(cfg, device="cpu")
    exp.run(3, ckpt=Checkpointer(d, max_to_keep=2), ckpt_every=1)
    return d, exp


def _restored(d, step=None, **kw):
    from rlgpuschedule_tpu_torch.checkpoint import Checkpointer
    cfg = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"], **CUT,
                              **kw)
    exp = Experiment.build(cfg, device="cpu")
    exp.restore_checkpoint(Checkpointer(d), step=step, train=False)
    return exp


def test_evaluate_cli_restores_a_checkpoint_in_a_subprocess(trained):
    """``evaluate --ckpt-dir`` in its own process reports the JCT table
    the trained experiment's own policy gives in this one, and names the
    step it restored."""
    import os
    import subprocess
    import sys
    d, exp = trained
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run(
        [sys.executable, "-m", "rlgpuschedule_tpu_torch.evaluate"]
        + CUT_FLAGS + ["--ckpt-dir", d, "--seed", "123", "--no-random",
                       "--eval-windows", "3", "--device", "cpu"],
        cwd=root, env=dict(os.environ, PYTHONPATH=root),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["repro"]["ckpt_step"] == exp.step == 6
    assert line["repro"]["ckpt_dir"] == d
    held = dataclasses.replace(exp.cfg, seed=123, drain_frac=0.0)
    from rlgpuschedule_tpu_torch import experiment as texp
    win = texp.make_env_windows(dataclasses.replace(held, n_envs=3),
                                texp.load_source_trace(held))
    want = teval.jct_report(exp, windows=win, include_random=False)
    for k in ROWS:
        assert line[k] == want[k], k
    assert "restored from" in p.stderr and "(step 6)" in p.stderr


def test_evaluate_cli_ckpt_step_and_drain_frac(trained, capsys):
    from rlgpuschedule_tpu_torch import evaluate as tevaluate
    d, _ = trained
    report = tevaluate.main(CUT_FLAGS + ["--ckpt-dir", d, "--ckpt-step", "4",
                                         "--drain-frac", "1.0",
                                         "--no-random", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["repro"]["ckpt_step"] == 4
    assert line["repro"]["drain_frac"] == 1.0
    exp = _restored(d, step=4, drain_frac=1.0)
    for w in exp.windows:
        assert (w.submit[w.valid] == 0.0).all()
    want = teval.jct_report(exp, include_random=False)
    for k in ROWS:
        assert report[k] == want[k], k
    with pytest.raises(FileNotFoundError):
        tevaluate.main(CUT_FLAGS + ["--ckpt-dir", d, "--ckpt-step", "2",
                                    "--device", "cpu"])


def test_evaluate_cli_full_trace_matches_the_library(trained, capsys):
    from rlgpuschedule_tpu_torch import evaluate as tevaluate
    d, _ = trained
    report = tevaluate.main(CUT_FLAGS + [
        "--ckpt-dir", d, "--full-trace", "--max-jobs", "40",
        "--stitch-drain-jobs", "3", "--stitch-window-jobs", "16",
        "--percentiles", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    exp = _restored(d)
    deep = dataclasses.replace(exp.env_params, sim=dataclasses.replace(
        exp.env_params.sim, max_jobs=16))
    want = teval.full_trace_report(exp, max_jobs=40, include_random=False,
                                   percentiles=(50, 90, 99),
                                   env_params=deep, drain_completions=3)
    assert line["n_jobs"] == report["n_jobs"] == 40
    assert line["drain_completions"] == 3
    for k in ("policy", "policy_windows", "fifo", "sjf", "srtf",
              "tiresias", "vs_tiresias"):
        assert report[k] == want[k], k
    assert np.isfinite(report["random"])
    assert set(line["percentiles"]) == {"policy", "random", "fifo", "sjf",
                                        "srtf", "tiresias"}


@pytest.mark.parametrize("argv,match", [
    (["--stitch-window-jobs", "16"], "--full-trace"),
    (["--stitch-drain-jobs", "4"], "--full-trace"),
    (["--full-trace", "--stitch-drain-jobs", "0"], ">= 1"),
    (["--full-trace", "--eval-windows", "2"], "--eval-windows"),
])
def test_evaluate_cli_full_trace_refuses_what_jax_refuses(argv, match):
    from rlgpuschedule_tpu import evaluate as jevaluate
    from rlgpuschedule_tpu_torch import evaluate as tevaluate
    with pytest.raises(SystemExit, match=match):
        jevaluate.main(CUT_FLAGS + argv)
    with pytest.raises(SystemExit, match=match):
        tevaluate.main(CUT_FLAGS + argv + ["--device", "cpu"])


# ---- the chaos and generalization matrices ----------------------------------

CHAOS_SMALL = dict(n_envs=3, n_nodes=4, gpus_per_node=4, window_jobs=12,
                   queue_len=4, horizon=96)


class ChaosPair:
    """Config 1 cut small under ``faults`` or ``domains`` on both sides:
    the JAX side as the attributes its reports read (the same host
    windows, no ``Experiment.build``), the port's a built experiment;
    the policy the JAX init's f32 weights on both."""

    def __init__(self, **regime):
        cfg_j = dataclasses.replace(jconfigs.CONFIGS["ppo-mlp-synth64"],
                                    **CHAOS_SMALL, **regime)
        cfg_t = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"],
                                    **CHAOS_SMALL, **regime)
        self.texp = Experiment.build(cfg_t, device="cpu")
        jp = jexp.build_env_params(cfg_j)
        windows = self.texp.windows
        traces = jenv.stack_traces(windows, jp)
        ts = jax.jit(lambda tr: jenv.vec_reset(jp, tr))(traces)[1]
        net = jmake_policy("flat", jp.n_actions, dtype=jnp.float32)
        self.params = jax.device_get(jax.jit(net.init)(
            jax.random.PRNGKey(5), ts.obs, ts.action_mask))
        self.jexp = types.SimpleNamespace(
            cfg=cfg_j, env_params=jp, windows=windows, traces=traces,
            source=self.texp.source, apply_fn=net.apply,
            train_state=types.SimpleNamespace(params=self.params))
        tp = self.texp.env_params
        tnet = make_policy("flat", tp.n_actions, tp.obs_shape(),
                           dtype=torch.float32, device="cpu")
        tnet.load_state_dict(params_from_jax(self.params))
        self.texp.train_state = self.texp.train_state._replace(net=tnet)


@pytest.fixture(scope="module")
def chaos_pairs():
    """One :class:`ChaosPair` per regime, built once for the module."""
    built = {}

    def get(**regime):
        key = tuple(sorted(regime.items()))
        if key not in built:
            built[key] = ChaosPair(**regime)
        return built[key]
    return get


def _cells_alike(got: dict, want: dict):
    """Every cell's avg JCT within 1e-6 relative, completion and the
    degradation's presence exact."""
    assert list(got) == list(want)
    for r in want:
        assert list(got[r]) == list(want[r]), r
        for s, cell in want[r].items():
            np.testing.assert_allclose(got[r][s]["avg_jct"], cell["avg_jct"],
                                       rtol=1e-6, err_msg=f"{r} {s}")
            assert got[r][s]["completion"] == cell["completion"], (r, s)
            np.testing.assert_allclose(got[r][s]["degradation"],
                                       cell["degradation"], rtol=1e-6)


@pytest.mark.parametrize("regime,baselines", [
    ("storm", ("sjf", "tiresias")),
    # JAX's Tiresias can livelock under a straggler draw
    # (tests/test_torch_faults.py): SRTF is the preemptive column here
    ("straggler", ("sjf", "srtf"))])
def test_chaos_report_matches_jax(chaos_pairs, regime, baselines):
    """Policy and baseline rows of the clean control and one regime."""
    p = chaos_pairs(faults="storm")
    kw = dict(regimes=(regime,), baselines=baselines, seed=3)
    want = jeval.chaos_report(p.jexp, **kw)
    got = teval.chaos_report(p.texp, **kw)
    assert got["chaos_regimes"] == want["chaos_regimes"]
    assert got["fault_horizon_s"] == want["fault_horizon_s"]
    assert got["fault_stats"] == want["fault_stats"]
    assert got["jobs_lost"] == want["jobs_lost"] == 0
    _cells_alike(got["regimes"], want["regimes"])
    degraded = [row["policy"]["avg_jct"] for row in got["regimes"].values()]
    assert len(set(degraded)) > 1, "the regimes changed nothing"
    text = teval.format_chaos(got)
    assert regime in text and "jobs lost across the matrix: 0" in text


def test_matrix_report_matches_jax_with_a_blind_row(chaos_pairs, tmp_path):
    """The domain-sighted policy and a clean (channel-blind) one as two
    rows, SJF as the baseline row, over the four default eval regimes."""
    p = chaos_pairs(domains="mixed")
    clean = chaos_pairs()
    jpol = {"mixed": (p.jexp.apply_fn, p.params, p.jexp.env_params),
            "clean": (clean.jexp.apply_fn, clean.params,
                      clean.jexp.env_params)}
    tpol = {"mixed": (p.texp.net, p.texp.env_params),
            "clean": (clean.texp.net, clean.texp.env_params)}
    want = jeval.matrix_report(p.jexp, baselines=("sjf",), policies=jpol,
                               seed=2)
    got = teval.matrix_report(p.texp, baselines=("sjf",), policies=tpol,
                              seed=2)
    assert got["domain_stats"] == want["domain_stats"]
    assert got["jobs_lost"] == want["jobs_lost"] == 0
    _cells_alike(got["cells"], want["cells"])
    assert "hetero" in teval.format_matrix(got)
    # under the alarms (the CPU's guard does nothing, the builds are
    # counted): the same cells, no alarm, the second row's first cell
    # with amnesty
    from rlgpuschedule_tpu_torch.obs import Alarms, EventBus, read_events
    bus = EventBus(str(tmp_path), rank=0)
    with Alarms(bus, device="cpu") as al:
        again = teval.matrix_report(p.texp, regimes=("hetero",),
                                    baselines=("sjf",), policies=tpol,
                                    seed=2, alarms=al)
    bus.close()
    assert again["cells"] == {r: got["cells"][r] for r in again["cells"]}
    assert set(again["cells"]) == {"none", "hetero"}
    assert not {e["kind"] for e in read_events(bus.path)} & {
        "recompile", "transfer"}
    assert al._dispatches == 4 and al._amnesty is None


def test_stitched_table_under_a_global_schedule_matches_jax(chaos_pairs):
    """``evaluate --full-trace --stitch-faults storm --stitch-domain
    geom`` as a library call: the policy stitched through the rebased
    schedule, the baselines on the oracle's global clock."""
    from rlgpuschedule_tpu import domains as jdom
    from rlgpuschedule_tpu.sim import faults as jfaults
    p = chaos_pairs(faults="storm")
    source = p.texp.source.slice(0, 48)
    sched = jdom.domain_schedule(
        jdom.sample_domain("geom", 4, 4, (1,)),
        jfaults.sample_fault_schedule(4, "storm", (1,),
                                      jfaults.fault_horizon([source])))
    kw = dict(max_jobs=source.num_jobs, include_random=False,
              baselines=("fifo", "sjf"), drain_completions=4)
    want = jeval.full_trace_report(p.jexp, faults=sched, **kw)
    got = teval.full_trace_report(p.texp, faults=tdom_schedule(sched), **kw)
    assert got["faulty_cluster"] and want["faulty_cluster"]
    assert got["baseline_backend"] == "python"
    for k in ("policy", "n_jobs", "policy_windows", "fifo", "sjf"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def tdom_schedule(sched):
    from rlgpuschedule_tpu_torch import domains as tdom
    return tdom.DomainSchedule(*(np.asarray(x) for x in sched))
