"""The port's trace generators and CSV loaders against the JAX
package's: the same seed, or the same file, gives byte-equal arrays,
field by field, and the same records; a CSV missing a needed column is
refused with the same error."""
import dataclasses
import os

import numpy as np
import pytest

from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu import experiment as jexp
from rlgpuschedule_tpu.sim import core as jcore
from rlgpuschedule_tpu.traces import gen_philly_proxy_trace as jphilly
from rlgpuschedule_tpu.traces import gen_poisson_trace as jpoisson
from rlgpuschedule_tpu.traces import pai as jpai
from rlgpuschedule_tpu.traces import philly as jphilly_csv
from rlgpuschedule_tpu.traces import philly_proxy as jproxy
from rlgpuschedule_tpu.traces.records import parse_status as jparse_status
from rlgpuschedule_tpu_torch import configs as tconfigs
from rlgpuschedule_tpu_torch import experiment as texp
from rlgpuschedule_tpu_torch.sim import core as tcore
from rlgpuschedule_tpu_torch.traces import gen_philly_proxy_trace as tphilly
from rlgpuschedule_tpu_torch.traces import gen_poisson_trace as tpoisson
from rlgpuschedule_tpu_torch.traces import pai as tpai
from rlgpuschedule_tpu_torch.traces import philly as tphilly_csv
from rlgpuschedule_tpu_torch.traces import philly_proxy as tproxy
from rlgpuschedule_tpu_torch.traces.records import parse_status

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")

FIELDS = ("submit", "duration", "gpus", "tenant", "valid")


def _same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("seed", [0, 11])
def test_poisson_trace_is_byte_equal(seed):
    kw = dict(mean_duration=450.0, n_tenants=3, max_jobs=300)
    _same(jpoisson(0.07, 257, seed, **kw), tpoisson(0.07, 257, seed, **kw))


@pytest.mark.parametrize("seed", [0, 5])
def test_philly_proxy_trace_is_byte_equal(seed):
    kw = dict(n_gpus=512, load=1.1, max_gang=512, n_tenants=14)
    _same(jphilly(3000, seed, **kw), tphilly(3000, seed, **kw))
    kw = dict(n_gpus=32, load=1.4, max_gang=8, n_tenants=1)
    _same(jphilly(500, seed, **kw), tphilly(500, seed, **kw))


@pytest.mark.parametrize("name", ["ppo-mlp-synth64", "ppo-cnn-philly512"])
@pytest.mark.parametrize("start", [0, 37])
def test_env_windows_are_byte_equal(name, start):
    over = dict(n_envs=5, source_jobs=600, seed=3)
    cfg_j = dataclasses.replace(jconfigs.CONFIGS[name], **over)
    cfg_t = dataclasses.replace(tconfigs.CONFIGS[name], **over)
    src_j, src_t = jexp.load_source_trace(cfg_j), texp.load_source_trace(cfg_t)
    _same(src_j, src_t)
    assert (jexp.windows_per_pass(src_j.num_jobs, cfg_j.window_jobs)
            == texp.windows_per_pass(src_t.num_jobs, cfg_t.window_jobs))
    for a, b in zip(jexp.make_env_windows(cfg_j, src_j, start),
                    texp.make_env_windows(cfg_t, src_t, start)):
        _same(a, b)


def test_validate_trace_refuses_or_clamps_like_jax():
    tr = jphilly(400, 2, n_gpus=512, load=1.1, max_gang=512)
    jp, tp = jcore.SimParams(4, 8, 400), tcore.SimParams(4, 8, 400)
    with pytest.raises(ValueError, match="clamp=True"):
        tcore.validate_trace(tp, tr)
    with pytest.raises(ValueError, match="clamp=True"):
        jcore.validate_trace(jp, tr)
    got = tcore.validate_trace(tp, tr, clamp=True)
    _same(jcore.validate_trace(jp, tr, clamp=True), got)
    assert int(got.gpus.max()) == 32


def test_unported_trace_sources_are_refused():
    """Every trace source is ported now; what is still refused is a CSV
    source with no file (JAX's error) and the PAI-proxy config made
    hierarchical (at build, in JAX's words: the fairness reward has no
    hierarchical form). Config 3 itself builds on JAX's windows."""
    cfg = tconfigs.CONFIGS["a2c-pai-fair"]
    _same(jexp.load_source_trace(jconfigs.CONFIGS["a2c-pai-fair"]),
          texp.load_source_trace(cfg))
    with pytest.raises(ValueError, match="JCT reward"):
        texp.Experiment.build(dataclasses.replace(cfg, n_pods=4),
                              device="cpu")
    exp = texp.Experiment.build(cfg, device="cpu")
    jcfg = jconfigs.CONFIGS["a2c-pai-fair"]
    jwins = jexp.make_env_windows(jcfg, jexp.load_source_trace(jcfg))
    for jw, tw in zip(jwins, exp.windows):
        _same(jw, tw)
    for trace in ("philly", "pai"):
        with pytest.raises(ValueError, match="no trace_path"):
            texp.load_source_trace(dataclasses.replace(cfg, trace=trace))
        with pytest.raises(ValueError, match="no trace_path"):
            jexp.load_source_trace(dataclasses.replace(
                jconfigs.CONFIGS["a2c-pai-fair"], trace=trace))
    np.testing.assert_equal(
        texp.windows_per_pass(1000, 128), jexp.windows_per_pass(1000, 128))


@pytest.mark.parametrize("loader,fixture", [
    ("load_philly", "philly_small.csv"), ("load_pai", "pai_small.csv")])
@pytest.mark.parametrize("max_jobs", [None, 2])
def test_csv_loaders_are_byte_equal(loader, fixture, max_jobs):
    path = os.path.join(FIXTURES, fixture)
    mod_j, mod_t = ((jphilly_csv, tphilly_csv) if loader == "load_philly"
                    else (jpai, tpai))
    _same(getattr(mod_j, loader)(path, max_jobs=max_jobs),
          getattr(mod_t, loader)(path, max_jobs=max_jobs))
    jobs_j = getattr(mod_j, loader + "_jobs")(path, max_jobs=max_jobs)
    jobs_t = getattr(mod_t, loader + "_jobs")(path, max_jobs=max_jobs)
    assert [dataclasses.astuple(j) for j in jobs_j] == \
        [dataclasses.astuple(j) for j in jobs_t]


@pytest.mark.parametrize("trace,fixture", [("philly", "philly_small.csv"),
                                           ("pai", "pai_small.csv")])
def test_csv_source_trace_matches_jax(trace, fixture):
    over = dict(trace=trace, trace_path=os.path.join(FIXTURES, fixture),
                n_nodes=1, gpus_per_node=8, window_jobs=2, n_envs=2)
    cfg_j = dataclasses.replace(jconfigs.CONFIGS["ppo-mlp-synth64"], **over)
    cfg_t = dataclasses.replace(tconfigs.CONFIGS["ppo-mlp-synth64"], **over)
    _same(jexp.load_source_trace(cfg_j), texp.load_source_trace(cfg_t))


@pytest.mark.parametrize("seed", [0, 9])
def test_pai_proxy_trace_is_byte_equal(seed):
    kw = dict(n_gpus=128, load=1.1, max_gang=128, n_tenants=8)
    _same(jproxy.gen_pai_proxy_trace(700, seed, **kw),
          tproxy.gen_pai_proxy_trace(700, seed, **kw))
    _same(jproxy.gen_pai_proxy_trace(300, seed, max_jobs=320),
          tproxy.gen_pai_proxy_trace(300, seed, max_jobs=320))


@pytest.mark.parametrize("header,mod", [
    ("job_id,num_gpus,duration", "philly"),      # no submit
    ("job_id,submit_time,duration", "philly"),   # no gpus
    ("job_id,submit_time,num_gpus,start_time", "philly"),  # no end
    ("job_name,submit_time,start_time,end_time", "pai"),   # no gpus
    ("job_name,plan_gpu,start_time", "pai"),               # no end
    ("job_name,submit_time,plan_gpu,end_time", "pai"),     # no start
])
def test_csv_missing_columns_raise_the_same_error(tmp_path, header, mod):
    path = tmp_path / "trace.csv"
    path.write_text(header + "\n" + ",".join(["1"] * len(header.split(",")))
                    + "\n")
    fn = "load_philly_jobs" if mod == "philly" else "load_pai_jobs"
    mod_j, mod_t = ((jphilly_csv, tphilly_csv) if mod == "philly"
                    else (jpai, tpai))
    with pytest.raises(ValueError) as want:
        getattr(mod_j, fn)(path)
    with pytest.raises(ValueError) as got:
        getattr(mod_t, fn)(path)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("s", ["Pass", " KILLED ", "failed", "Cancelled",
                               "Terminated", "weird", 2, np.int32(1)])
def test_parse_status_matches_jax(s):
    assert parse_status(s) == jparse_status(s)


@pytest.mark.parametrize("name", ["ppo-mlp-synth64", "ppo-cnn-philly512"])
def test_held_out_source_trace_matches_jax(name):
    """The held-out trace the eval probe and the evaluation phases cut
    (the config's seed + 1000, sized by its own windows) is JAX's."""
    over = dict(seed=tconfigs.CONFIGS[name].seed + 1000, n_envs=6,
                source_jobs=None)
    cfg_j = dataclasses.replace(jconfigs.CONFIGS[name], **over)
    cfg_t = dataclasses.replace(tconfigs.CONFIGS[name], **over)
    src_j, src_t = jexp.load_source_trace(cfg_j), texp.load_source_trace(cfg_t)
    _same(src_j, src_t)
    assert src_t.num_jobs == max(cfg_t.window_jobs * 8,
                                 1024 if cfg_t.trace == "synthetic" else 4096)
