"""The full-trace stitched replay of the port against the JAX package's.

A small cluster (4 nodes x 4 GPUs, a 12-row job table, queue 4) replays
whole synthetic streams through both packages' ``full_trace_replay``
with the same f32 weights (a JAX init, its policy head scaled by 100 so
that no greedy decision is a near-tie, converted with
``params_from_jax``): an underloaded stream and an overloaded one (deep
backlog), with ``drain_completions`` 1 and 4, with a backlog gate, and
a preemptive config whose policy cycles place<->preempt until the stall
guard breaks it. ``n_windows`` and the finished-job count must be
exact, every per-job global finish time and the avg JCT within rtol
1e-6. ``full_trace_report`` must carry JAX's keys, its baseline rows
equal and its policy row within rtol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu import eval as jeval
from rlgpuschedule_tpu import experiment as jexp
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu.sim.core import validate_trace as jvalidate
from rlgpuschedule_tpu_torch import configs as tconfigs
from rlgpuschedule_tpu_torch import eval as teval
from rlgpuschedule_tpu_torch import experiment as texp
from rlgpuschedule_tpu_torch.env.env import EnvParams, stack_traces
from rlgpuschedule_tpu_torch.models import params_from_jax
from rlgpuschedule_tpu_torch.sim.core import SimParams, validate_trace
from rlgpuschedule_tpu_torch.sim.faults import no_faults
from rlgpuschedule_tpu_torch.sim.schedulers import run_baseline
from rlgpuschedule_tpu_torch.traces import gen_poisson_trace
from torch_jax_builds import fast_jax_build

# the tensors here are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

SMALL = dict(n_envs=2, n_nodes=4, gpus_per_node=4, window_jobs=12,
             queue_len=4, horizon=96)
RTOL = 1e-6


class Pair:
    """One small config in both packages: its source stream (from each
    package's own generator, byte-equal) and one f32 policy."""

    def __init__(self, name="ppo-mlp-synth64", n_jobs=48, seed=7, **kw):
        cfg_j = dataclasses.replace(jconfigs.CONFIGS[name], **SMALL, **kw)
        cfg_t = dataclasses.replace(tconfigs.CONFIGS[name], **SMALL, **kw)
        self.jp = jexp.build_env_params(cfg_j)
        self.tp = texp.build_env_params(cfg_t)
        self.jsrc = jvalidate(self.jp.sim, jexp.load_source_trace(
            cfg_j, n_jobs=n_jobs, seed=seed), clamp=True)
        self.tsrc = validate_trace(self.tp.sim, texp.load_source_trace(
            cfg_t, n_jobs=n_jobs, seed=seed), clamp=True)
        for f in ("submit", "duration", "gpus", "valid"):
            assert np.asarray(getattr(self.jsrc, f)).tobytes() == \
                getattr(self.tsrc, f).tobytes(), f
        net = jmake_policy(cfg_j.obs_kind, self.jp.n_actions,
                           dtype=jnp.float32)
        self.apply_fn = lambda p, o, m: net.apply(p, o, m)
        obs0 = jnp.zeros((1,) + self.jp.obs_shape())
        mask0 = jnp.ones((1, self.jp.n_actions), bool)
        params = jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(3),
                                                  obs0, mask0))
        tree = params["params"]
        tree["policy"]["kernel"] = np.asarray(tree["policy"]["kernel"]) * 100
        if cfg_j.preempt_len:
            # place<->preempt is the argmax whenever both are legal
            kp = cfg_j.queue_len * cfg_j.n_placements
            bias = np.array(tree["policy"]["bias"])
            bias[kp], bias[0] = 20.0, 10.0
            tree["policy"]["bias"] = bias
        self.params = params
        self.net = texp.build_policy(cfg_t, self.tp, dtype=torch.float32,
                                     device="cpu")
        self.net.load_state_dict(params_from_jax(params))
        self.cfg_j, self.cfg_t = cfg_j, cfg_t

    def both(self, **kw):
        want = jeval.full_trace_replay(self.apply_fn, self.params, self.jp,
                                       self.jsrc, **kw)
        got = teval.full_trace_replay(self.net, self.tp, self.tsrc, **kw)
        return want, got


def _assert_same(want, got):
    assert got["windows"] == want["windows"]
    assert got["n_jobs"] == want["n_jobs"]
    assert got["drain_completions"] == want["drain_completions"]
    assert np.isfinite(got["finish"]).sum() == np.isfinite(
        want["finish"]).sum() == got["n_jobs"]
    np.testing.assert_allclose(got["finish"], want["finish"], rtol=RTOL)
    np.testing.assert_allclose(got["jct"], want["jct"], rtol=RTOL,
                               atol=1e-3)
    np.testing.assert_allclose(got["avg_jct"], want["avg_jct"], rtol=RTOL)
    np.testing.assert_array_equal(got["tenant"], want["tenant"])


@pytest.fixture(scope="module")
def under():
    # offered load about 0.4 of the 16 GPUs
    return Pair(arrival_rate=0.005)


@pytest.fixture(scope="module")
def over():
    # about twice what the 16 GPUs serve: a backlog that outruns the
    # arrivals, so windows run in deep-backlog (completion) mode
    return Pair(arrival_rate=0.3, n_jobs=40)


def test_underloaded_stream_matches_jax(under):
    want, got = under.both()
    _assert_same(want, got)
    assert got["windows"] > 1


@pytest.mark.parametrize("drain", [1, 4])
def test_overloaded_stream_matches_jax(over, drain):
    want, got = over.both(drain_completions=drain)
    _assert_same(want, got)
    # deep backlog: more windows than the table's fresh-ingest count
    assert got["windows"] > over.tsrc.num_jobs // SMALL["window_jobs"]


def test_backlog_gated_stitch_matches_jax(over):
    want, got = over.both(backlog_gate=3)
    _assert_same(want, got)


def test_preemptive_stitch_with_the_stall_guard_matches_jax():
    p = Pair("ppo-mlp-preempt", n_jobs=24, seed=1)
    want, got = p.both(max_steps_per_window=512)
    _assert_same(want, got)
    # unguarded, the first place<->preempt cycle never frees a row
    with pytest.raises(RuntimeError, match="no progress"):
        teval.full_trace_replay(p.net, p.tp, p.tsrc,
                                max_steps_per_window=64, stall_guard=False)


def test_full_trace_report_matches_jax():
    cfg_kw = dict(SMALL, window_jobs=16, source_jobs=60)
    cfg_j = dataclasses.replace(jconfigs.CONFIGS["ppo-mlp-synth64"],
                                **cfg_kw)
    cfg_t = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"],
                                **cfg_kw)
    ej = fast_jax_build(cfg_j)
    net32 = jmake_policy("flat", ej.env_params.n_actions, dtype=jnp.float32)
    ej = dataclasses.replace(ej, apply_fn=lambda p, o, m: net32.apply(
        p, o, m))
    et = texp.Experiment.build(cfg_t, device="cpu")
    net = texp.build_policy(cfg_t, et.env_params, dtype=torch.float32,
                            device="cpu")
    net.load_state_dict(params_from_jax(jax.device_get(
        ej.train_state.params)))
    et.train_state = et.train_state._replace(net=net)
    want = jeval.full_trace_report(ej, max_jobs=50, percentiles=(50, 99),
                                   drain_completions=2)
    got = teval.full_trace_report(et, max_jobs=50, percentiles=(50, 99),
                                  drain_completions=2)
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"baseline_backend", "wall_s"}
    for k in ("n_jobs", "policy_windows", "drain_completions"):
        assert got[k] == want[k], k
    for k in ("fifo", "sjf", "srtf", "tiresias"):
        assert got[k] == pytest.approx(want[k], rel=1e-9), k
    for k in ("policy", "vs_tiresias"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    assert np.isfinite(got["random"]) and got["random"] > 0
    assert set(got["percentiles"]) == set(want["percentiles"])
    for c, v in want["percentiles"]["tiresias"].items():
        assert got["percentiles"]["tiresias"][c] == pytest.approx(v)
    assert set(got["wall_s"]) == {"policy_replay", "random_replay",
                                  "baselines"}
    assert "tiresias" in teval.format_report(got)


def test_single_window_equals_the_plain_replay():
    """With the job table as deep as the trace, the stitched replay is
    one window run to completion: the plain replay of that window."""
    cfg = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"],
                              **dict(SMALL, window_jobs=40, horizon=400))
    exp = texp.Experiment.build(cfg, device="cpu")
    src = exp.source.slice(0, 40)
    out = teval.full_trace_replay(exp.net, exp.env_params, src)
    assert out["windows"] == 1 and out["n_jobs"] == 40
    res = teval.replay(exp.net, exp.env_params,
                       stack_traces([src], exp.env_params, "cpu"), 400)
    assert int(res.n_done[0]) == 40
    assert out["avg_jct"] == pytest.approx(float(res.avg_jct[0]), rel=1e-5)


class _Fifo(torch.nn.Module):
    """The lowest legal queue slot, the no-op only when nothing fits."""

    def forward(self, obs, mask):
        n = mask.shape[-1]
        prefs = torch.arange(n, 0, -1, dtype=torch.float32)
        prefs[-1] = 0.5
        return torch.where(mask, prefs, -1e9), torch.zeros(obs.shape[0])

    def parameters(self, recurse=True):
        yield torch.zeros(())


def test_stitched_fifo_tracks_the_oracle():
    """A hand FIFO policy stitched through 8-row windows: on a stream
    with no lasting backlog it finishes every job when the oracle's FIFO
    does; under overload it is only ever pessimistic, within 1.5x."""
    sim = SimParams(n_nodes=2, gpus_per_node=4, max_jobs=8, queue_len=4)
    params = EnvParams(sim=sim, obs_kind="flat", horizon=512)
    kw = dict(mean_duration=200.0, gpu_sizes=(1, 2), gpu_probs=(0.7, 0.3))
    light = validate_trace(sim, gen_poisson_trace(0.05, 24, 0, **kw),
                           clamp=True)
    out = teval.full_trace_replay(_Fifo(), params, light)
    np.testing.assert_allclose(out["finish"][:24],
                               run_baseline(light, 2, 4, "fifo")
                               .finish[:24], rtol=1e-4)
    heavy = validate_trace(sim, gen_poisson_trace(0.3, 30, 0, **kw),
                           clamp=True)
    one = teval.full_trace_replay(_Fifo(), params, heavy)
    four = teval.full_trace_replay(_Fifo(), params, heavy,
                                   drain_completions=100)
    true_jct = run_baseline(heavy, 2, 4, "fifo").avg_jct()
    for out in (one, four):
        assert true_jct * 0.999 <= out["avg_jct"] <= true_jct * 1.5
    assert four["drain_completions"] == 4
    assert four["windows"] < one["windows"] / 2


@pytest.mark.parametrize("kw,err,match", [
    (dict(faults=no_faults(3)), ValueError, "schedule covers 3 nodes"),
    (dict(drain_completions=0), ValueError, "drain_completions"),
    (dict(policy="random", backlog_gate=2), ValueError, "backlog_gate"),
    (dict(backlog_gate=-1), ValueError, ">= 0"),
    (dict(policy="sjf"), ValueError, "unknown replay policy"),
])
def test_full_trace_replay_refuses_like_jax(under, kw, err, match):
    with pytest.raises(err, match=match):
        teval.full_trace_replay(under.net, under.tp, under.tsrc, **kw)


def test_full_trace_report_takes_a_deeper_stitch_window_only():
    cfg = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"],
                              **dict(SMALL, window_jobs=16))
    exp = texp.Experiment.build(cfg, device="cpu")
    kw = dict(max_jobs=60, include_random=False, baselines=("fifo",))
    base = teval.full_trace_report(exp, **kw)
    deep = teval.full_trace_report(exp, env_params=dataclasses.replace(
        exp.env_params, sim=dataclasses.replace(exp.env_params.sim,
                                                max_jobs=48)), **kw)
    assert deep["n_jobs"] == base["n_jobs"] == 60
    assert deep["policy_windows"] < base["policy_windows"]
    bad = dataclasses.replace(exp.env_params, sim=dataclasses.replace(
        exp.env_params.sim, queue_len=8))
    with pytest.raises(ValueError, match="stitch window"):
        teval.full_trace_report(exp, env_params=bad)
    with pytest.raises(ValueError, match="schedule covers 3 nodes"):
        teval.full_trace_report(exp, faults=no_faults(3))
