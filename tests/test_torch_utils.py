"""Parity of the port's ``utils`` (metrics logging, profiling) with the
JAX package's.

- ``MetricsLogger``: the CSV is byte-equal to JAX's for the same rows
  with the clock injected, fresh, appended on resume and under both
  schema-drift errors (the messages word for word);
- ``TensorBoardWriter``: the event file (name and bytes) is byte-equal
  to JAX's with ``time.time``, the host name and the pid fixed; the
  crc32c and its mask equal JAX's on seeded bytes and the standard
  check value;
- ``ThroughputMeter`` and ``SectionTimer``: the same figures from the
  same injected clocks;
- ``profiling.trace`` writes a Chrome trace that ``json`` reads, and on
  a CUDA device without the profiler's CUDA activity it raises;
- ``profiling.debug_checks`` raises ``FloatingPointError`` on a policy
  step with a poisoned weight where JAX's ``debug_checks`` raises on
  the same weights, and neither raises on the clean weights; a clean
  training iteration runs under it.
"""
import dataclasses
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu.utils import logging as jlog
from rlgpuschedule_tpu.utils import profiling as jprof
from rlgpuschedule_tpu_torch.configs import CONFIGS
from rlgpuschedule_tpu_torch.experiment import Experiment
from rlgpuschedule_tpu_torch.models import make_policy, params_from_jax
from rlgpuschedule_tpu_torch.utils import logging as tlog
from rlgpuschedule_tpu_torch.utils import profiling as tprof

ROWS = [(0, {"total_loss": 0.25, "mean_reward": -1.5, "note": "a"}),
        (10, {"total_loss": np.float32(0.125), "mean_reward": -0.75,
              "note": "b"}),
        (20, {"total_loss": 1e-9, "mean_reward": 3, "note": "c"})]


def _ticks(monkeypatch, module):
    """Each ``time.monotonic()`` reads 0.5 s after the last one."""
    clock = itertools.count(0.0, 0.5)
    monkeypatch.setattr(module.time, "monotonic", lambda: next(clock))


def _write_csv(monkeypatch, module, path, rows, append=False):
    _ticks(monkeypatch, module)
    with module.MetricsLogger(path, append=append) as log:
        for i, m in rows:
            log(i, m)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("mode", ["fresh", "append"])
def test_metrics_logger_csv_is_jax_byte_for_byte(tmp_path, monkeypatch,
                                                 mode):
    out = {}
    for name, module in (("jax", jlog), ("torch", tlog)):
        path = str(tmp_path / name / "m.csv")
        if mode == "append":
            _write_csv(monkeypatch, module, path, ROWS[:2])
            out[name] = _write_csv(monkeypatch, module, path, ROWS[2:],
                                   append=True)
        else:
            out[name] = _write_csv(monkeypatch, module, path, ROWS)
    assert out["torch"] == out["jax"]
    assert out["torch"].count(b"\n") == 4     # the header and 3 rows


def test_metrics_logger_append_to_a_missing_file_starts_fresh(tmp_path,
                                                              monkeypatch):
    a = _write_csv(monkeypatch, jlog, str(tmp_path / "j.csv"), ROWS,
                   append=True)
    b = _write_csv(monkeypatch, tlog, str(tmp_path / "t.csv"), ROWS,
                   append=True)
    assert a == b and b.startswith(b"iteration,wall_s,")


@pytest.mark.parametrize("where", ["in_run", "across_resume"])
def test_metrics_logger_schema_drift_errors_match_jax(tmp_path, where):
    errors = {}
    for name, module in (("jax", jlog), ("torch", tlog)):
        path = str(tmp_path / name / "m.csv")
        if where == "across_resume":
            with module.MetricsLogger(path) as log:
                log(0, {"a": 1.0, "b": 2.0})
            log = module.MetricsLogger(path, append=True)
        else:
            log = module.MetricsLogger(path)
            log(0, {"a": 1.0, "b": 2.0})
        with pytest.raises(ValueError) as e:
            log(1, {"a": 1.0, "c": 2.0})
        log.close()
        errors[name] = str(e.value)
    assert errors["torch"] == errors["jax"]
    assert "schema drift" in errors["torch"]


def test_metrics_logger_echo_line_matches_jax(tmp_path, monkeypatch):
    import io
    lines = {}
    for name, module in (("jax", jlog), ("torch", tlog)):
        _ticks(monkeypatch, module)
        s = io.StringIO()
        log = module.MetricsLogger(None, echo=True, stream=s)
        for i, m in ROWS:
            log(i, m)
        lines[name] = s.getvalue()
    assert lines["torch"] == lines["jax"] and lines["torch"].count("\n") == 3


def test_tensorboard_file_is_jax_byte_for_byte(tmp_path, monkeypatch):
    import socket
    monkeypatch.setattr(socket, "gethostname", lambda: "host")
    monkeypatch.setattr(os, "getpid", lambda: 4242)
    files = {}
    for name, module in (("jax", jlog), ("torch", tlog)):
        monkeypatch.setattr(module.time, "time",
                            lambda: 1_700_000_000.25)
        with module.TensorBoardWriter(str(tmp_path / name)) as tb:
            tb(3, {"mean_reward": -0.5, "note": "skipped-non-float"})
            tb(7, {"mean_reward": 1.25, "total_loss": np.float32(0.5)})
            tb(8, {"note": "nothing to write"})
            path = tb.path
        with open(path, "rb") as f:
            files[name] = (os.path.basename(path), f.read())
    assert files["torch"] == files["jax"]
    assert files["torch"][0] == "events.out.tfevents.1700000000.host.4242"


def test_crc32c_and_its_mask_match_jax():
    rng = np.random.default_rng(0)
    assert tlog._crc32c(b"123456789") == 0xE3069283   # the check value
    for n in (0, 1, 7, 64, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tlog._crc32c(data) == jlog._crc32c(data)
        assert tlog._masked_crc(data) == jlog._masked_crc(data)
    for v in (0, 1, 127, 128, 300, 2 ** 40, -1):
        assert tlog._varint(v) == jlog._varint(v)


def test_throughput_meter_matches_jax():
    got = []
    for module in (jlog, tlog):
        clock = itertools.count(10.0, 2.0)
        m = module.ThroughputMeter(clock=lambda: next(clock))
        m.tick(100)
        m.tick(60)
        got.append(m.steps_per_sec)
    assert got[0] == got[1] == 160 / 2.0
    frozen = tlog.ThroughputMeter(clock=lambda: 5.0)
    frozen.tick(10)
    assert frozen.steps_per_sec == 0.0


def test_section_timer_matches_jax(monkeypatch):
    reports = []
    for module in (jprof, tprof):
        clock = itertools.count(0.0, 0.25)
        monkeypatch.setattr(module.time, "perf_counter",
                            lambda: next(clock))
        t = module.SectionTimer()
        for name in ("a", "b", "a"):
            with t(name):
                pass
        with pytest.raises(RuntimeError):
            with t("c"):
                raise RuntimeError("the section still counts")
        reports.append(t.report())
    assert reports[0] == reports[1] == {"a": 0.5, "b": 0.25, "c": 0.25}


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    net = torch.nn.Linear(4, 2)
    with tprof.trace(str(tmp_path / "tr"), "cpu") as session:
        net(torch.ones(3, 4)).sum().backward()
    files = os.listdir(tmp_path / "tr")
    assert files == [os.path.basename(session.path)]
    assert files[0].endswith(".pt.trace.json")
    with open(session.path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("addmm" in str(n) for n in names)


def test_trace_on_a_card_without_cupti_raises(tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="CUPTI"):
        with tprof.trace(str(tmp_path / "tr"), "cuda"):
            pass
    assert not os.path.exists(tmp_path / "tr")


def test_device_busy_is_the_union_of_the_cards_intervals(monkeypatch):
    # overlapping, nested, touching and disjoint intervals, unsorted
    spans = [(50, 60), (0, 10), (5, 20), (6, 8), (20, 25), (100, 101)]
    assert tprof.covered_ns(spans) == 25 + 10 + 1
    assert tprof.covered_ns([]) == 0
    with pytest.raises(ValueError, match="CUDA device"):
        tprof.device_busy_ms(lambda: None, 1, "cpu")
    from torch.profiler import ProfilerActivity
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    with pytest.raises(RuntimeError, match="CUPTI"):
        tprof.device_busy_ms(lambda: None, 1, "cuda")


OBS_DIM, N_ACT = 18, 4


@pytest.fixture(scope="module")
def policies():
    """A flat f32 actor-critic in both packages with the JAX init's
    weights, and a seeded batch."""
    jnet = jmake_policy("flat", N_ACT, dtype=jnp.float32)
    obs = np.random.default_rng(1).random((8, OBS_DIM), dtype=np.float32)
    mask = np.ones((8, N_ACT), bool)
    params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(3),
                                               obs[:1], mask[:1]))
    return jnet, params, obs, mask


def _poisoned(params):
    flat = params_from_jax(params)
    first = next(k for k, v in flat.items() if v.ndim == 2)
    poisoned = jax.tree.map(np.array, params)
    leaves = jax.tree_util.tree_leaves_with_path(poisoned)
    # the same element of the same kernel on both sides
    for path, leaf in leaves:
        if leaf.ndim == 2:
            leaf[0, 0] = np.nan
            break
    return poisoned, first


def _jax_step(jnet, params, obs, mask):
    def loss(p):
        logits, value = jnet.apply(p, obs, mask)
        return jnp.sum(value) + jnp.sum(jax.nn.log_softmax(logits))
    return jax.jit(jax.grad(loss))(params)


def _torch_net(params):
    net = make_policy("flat", N_ACT, (OBS_DIM,), dtype=torch.float32,
                      device="cpu")
    net.load_state_dict(params_from_jax(params))
    return net


def _torch_step(net, obs, mask):
    logits, value = net(torch.tensor(obs), torch.tensor(mask))
    (value.sum() + torch.log_softmax(logits, -1).sum()).backward()
    return net


@pytest.mark.parametrize("poison", [False, True])
def test_debug_checks_raise_where_jax_raises(policies, poison):
    jnet, params, obs, mask = policies
    if poison:
        params, name = _poisoned(params)
        assert torch.isnan(params_from_jax(params)[name]).any()
    net = _torch_net(params)
    outcome = {}
    for side in ("jax", "torch"):
        try:
            if side == "jax":
                with jprof.debug_checks():
                    jax.block_until_ready(_jax_step(jnet, params, obs,
                                                    mask))
            else:
                with tprof.debug_checks():
                    _torch_step(net, obs, mask)
            outcome[side] = None
        except FloatingPointError as e:
            outcome[side] = str(e)
    assert (outcome["torch"] is not None) == (outcome["jax"] is not None) \
        == poison, outcome
    if poison:
        assert outcome["torch"].startswith(
            "invalid value (nan) encountered in aten.")


def test_debug_checks_skip_unwritten_buffers_and_their_views():
    with tprof.debug_checks():
        buf = torch.empty(64, 64).view(-1)[:10]      # never checked
        buf.copy_(torch.ones(10))
        net = torch.nn.Linear(8, 8)                  # empty, then init
        assert torch.isfinite(net(torch.ones(2, 8))).all()


def test_debug_checks_is_a_no_op_when_off_and_lets_inf_through():
    x = torch.tensor([1.0, 0.0])
    with tprof.debug_checks(nans=False):
        assert torch.isnan(x / x)[1]
    with tprof.debug_checks():
        assert torch.isinf(x[:1] / 0.0).all()    # +inf is legal
        with pytest.raises(FloatingPointError, match="aten.div"):
            x / x


def test_a_clean_training_iteration_runs_under_debug_checks():
    cfg = CONFIGS["ppo-mlp-synth64"]
    cfg = dataclasses.replace(
        cfg, n_envs=2, window_jobs=16, horizon=64,
        ppo=dataclasses.replace(cfg.ppo, n_steps=8, n_epochs=1,
                                n_minibatches=2))
    exp = Experiment.build(cfg, device="cpu")
    with tprof.debug_checks():
        out = exp.run(2, log_every=1)
    assert all(np.isfinite(list(h.values())).all() for h in out["history"])
