"""The port's oracle simulator, baseline schedulers and native engine
against the JAX package's.

- ``OracleSim`` and all four baselines on the Python backend: on
  overloaded Poisson traces (deep queues, preemption, Tiresias
  demotions) per-job finish and start times are equal bit for bit and
  the status arrays equal; placements and ``rl_step`` agree step by step;
- the port's native engine against the JAX package's native engine (bit
  for bit: the same C++ code) and against the port's Python oracle, at
  ``tests/test_native.py``'s tolerances (finish and start within
  atol 1e-6, status equal, avg JCT rel 1e-9);
- the hand-checked FIFO and SRTF cases of ``tests/test_native.py``;
- what the port refuses: a fault schedule on the native engine or shaped
  for another cluster, and a native build that fails
  while a compiler is present (it raises; only a missing compiler lets
  ``backend="auto"`` run the Python oracle).
"""
import os
import stat

import numpy as np
import pytest

from rlgpuschedule_tpu import native as jnative
from rlgpuschedule_tpu.sim import oracle as joracle
from rlgpuschedule_tpu.sim.schedulers import run_baseline as jrun_baseline
from rlgpuschedule_tpu.traces import gen_poisson_trace as jpoisson
from rlgpuschedule_tpu_torch import native
from rlgpuschedule_tpu_torch.sim import oracle, schedulers
from rlgpuschedule_tpu_torch.sim.schedulers import (evaluate_baselines,
                                                    resolve_backend,
                                                    run_baseline)
from rlgpuschedule_tpu_torch.traces import gen_poisson_trace
from rlgpuschedule_tpu_torch.traces.records import JobRecord, to_array_trace

POLICIES = ("fifo", "sjf", "srtf", "tiresias")


def _overloaded(seed):
    """The same overloaded trace from each package's generator."""
    kw = dict(mean_duration=2000.0)
    return gen_poisson_trace(0.05, 80, seed, **kw), jpoisson(0.05, 80, seed,
                                                             **kw)


def _inf(x):
    return np.where(np.isnan(x), np.inf, x)


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_python_baselines_match_jax_bit_for_bit(name, seed):
    tr, jtr = _overloaded(seed)
    got = run_baseline(tr, 2, 8, name, backend="python")
    want = jrun_baseline(jtr, 2, 8, name, backend="python")
    assert isinstance(got, oracle.OracleSim)
    assert got.finish.tobytes() == want.finish.tobytes()
    assert got.start.tobytes() == want.start.tobytes()
    np.testing.assert_array_equal(got.status, want.status)
    assert got.gpus_consistent()
    assert got.avg_jct() == want.avg_jct()


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_engine_matches_jax_native_and_the_python_oracle(name, seed):
    tr, jtr = _overloaded(seed)
    nat = run_baseline(tr, 2, 8, name, backend="native")
    assert isinstance(nat, native.NativeSimResult)
    jnat = jrun_baseline(jtr, 2, 8, name, backend="native")
    assert nat.finish.tobytes() == jnat.finish.tobytes()
    assert nat.start.tobytes() == jnat.start.tobytes()
    py = run_baseline(tr, 2, 8, name, backend="python")
    for f in ("finish", "start"):
        np.testing.assert_allclose(_inf(getattr(nat, f))[tr.valid],
                                   _inf(getattr(py, f))[tr.valid],
                                   rtol=0, atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(nat.status, py.status)
    assert nat.avg_jct() == pytest.approx(py.avg_jct(), rel=1e-9)


@pytest.mark.parametrize("name", POLICIES)
def test_underloaded_trace_backends_agree(name):
    tr = gen_poisson_trace(0.001, 30, seed=3, mean_duration=100.0)
    py = run_baseline(tr, 4, 8, name, backend="python")
    nat = run_baseline(tr, 4, 8, name, backend="native")
    assert nat.avg_jct() == pytest.approx(py.avg_jct(), rel=1e-9)


def test_evaluate_baselines_matches_jax():
    from rlgpuschedule_tpu.sim.schedulers import evaluate_baselines as jeval
    tr, jtr = _overloaded(4)
    assert evaluate_baselines(tr, 2, 8) == jeval(jtr, 2, 8)


@pytest.mark.parametrize("backend", ["python", "native"])
def test_hand_checked_fifo(backend):
    """2-GPU cluster, three 2-GPU jobs of 10 s at t=0: FIFO serializes
    them, finishing at 10, 20 and 30."""
    tr = to_array_trace([JobRecord(0, 0.0, 10.0, 2),
                         JobRecord(1, 0.0, 10.0, 2),
                         JobRecord(2, 0.0, 10.0, 2)])
    res = run_baseline(tr, 1, 2, "fifo", backend=backend)
    np.testing.assert_allclose(sorted(res.jcts()), [10.0, 20.0, 30.0])


def test_srtf_preempts():
    """A long job starts, a short one arrives: SRTF preempts the long
    one, so the short job's JCT is its duration."""
    tr = to_array_trace([JobRecord(0, 0.0, 100.0, 2),
                         JobRecord(1, 5.0, 10.0, 2)])
    nat = run_baseline(tr, 1, 2, "srtf", backend="native")
    py = run_baseline(tr, 1, 2, "srtf", backend="python")
    np.testing.assert_allclose(sorted(nat.jcts()), sorted(py.jcts()))
    assert min(nat.jcts()) == pytest.approx(10.0)
    # the long job keeps its first start across the preemption
    assert py.start[0] == 0.0 and nat.start[0] == 0.0


@pytest.mark.parametrize("seed", range(4))
def test_placements_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        free = rng.integers(0, 9, size=6).astype(np.int32)
        demand = int(rng.integers(1, 30))
        for mine, ref in ((oracle.pack_placement, joracle.pack_placement),
                          (oracle.spread_placement,
                           joracle.spread_placement)):
            got, want = mine(free, demand), ref(free, demand)
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_rl_step_matches_jax_step_by_step(seed):
    """Random actions (places in pack and spread mode, preemptions,
    no-ops) drive both oracles; every step's info, clock, status and
    allocation agree exactly."""
    tr, jtr = _overloaded(seed)
    mine, ref = oracle.OracleSim(tr, 2, 8), joracle.OracleSim(jtr, 2, 8)
    rng = np.random.default_rng(seed)
    K, P, R = 4, 2, 2
    for _ in range(400):
        a = int(rng.integers(0, K * P + R + 1))
        got = mine.rl_step(a, K, P, R)
        want = ref.rl_step(a, K, P, R)
        assert got == want
        assert mine.clock == ref.clock
        np.testing.assert_array_equal(mine.status, ref.status)
        np.testing.assert_array_equal(mine.alloc, ref.alloc)
        if want["done"]:
            break
    assert mine.pending_jobs() == ref.pending_jobs()
    assert mine.utilization() == ref.utilization()


def test_faults_are_refused():
    """What the port refuses of a fault schedule, as JAX refuses it: one
    shaped for another cluster, and any on the native engine (which has
    no fault model; ``tests/test_torch_faults.py`` runs the rest)."""
    from rlgpuschedule_tpu_torch.sim.faults import no_faults
    tr, _ = _overloaded(0)
    with pytest.raises(ValueError, match="the cluster has 2"):
        oracle.OracleSim(tr, 2, 8, faults=no_faults(3))
    with pytest.raises(ValueError, match="no fault model"):
        run_baseline(tr, 2, 8, "fifo", backend="native",
                     faults=no_faults(2))
    assert run_baseline(tr, 2, 8, "fifo", faults=no_faults(2)).avg_jct() \
        == run_baseline(tr, 2, 8, "fifo", backend="python").avg_jct()


def test_errors_match_jax():
    tr = to_array_trace([JobRecord(0, 0.0, 10.0, 64)])
    with pytest.raises(RuntimeError, match="invalid input"):
        native.run_baseline_native(tr, 1, 8, "fifo")
    with pytest.raises(ValueError, match="more GPUs"):
        oracle.OracleSim(tr, 1, 8)
    ok = to_array_trace([JobRecord(0, 0.0, 10.0, 1)])
    with pytest.raises(ValueError):
        native.run_baseline_native(ok, 1, 8, "nope")
    with pytest.raises(ValueError, match="unknown baseline"):
        run_baseline(ok, 1, 8, "nope", backend="python")
    with pytest.raises(ValueError, match="unknown backend"):
        run_baseline(ok, 1, 8, "fifo", backend="gpu")


def test_the_engine_builds_its_own_source_into_its_own_cache(tmp_path,
                                                             monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    engine = native.NativeEngine()
    assert os.path.dirname(engine.src) == os.path.dirname(native.__file__)
    assert engine.load() is not None
    d = tmp_path / "rlgpuschedule_tpu_torch"
    built = [p.name for p in d.iterdir()]
    assert len(built) == 1 and built[0].startswith("fast_oracle_") \
        and built[0].endswith(".so")
    assert stat.S_IMODE(d.stat().st_mode) == 0o700
    # the JAX package's engine caches under its own name
    assert "rlgpuschedule_tpu_torch" not in jnative._so_path()


def test_a_failed_build_with_a_compiler_present_raises(tmp_path,
                                                       monkeypatch):
    broken = tmp_path / "fast_oracle.cpp"
    broken.write_text(open(native.SRC).read() + "\nthis is not C++;\n")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setattr(native, "_ENGINE", native.NativeEngine(str(broken)))
    tr = gen_poisson_trace(0.01, 10, 0)
    with pytest.raises(native.NativeBuildError, match="build or load"):
        native.available()
    for backend in ("auto", "native"):
        with pytest.raises(native.NativeBuildError):
            run_baseline(tr, 2, 8, "fifo", backend=backend)
    # asked again, it raises again: no later call falls back either
    with pytest.raises(native.NativeBuildError):
        resolve_backend("auto")
    assert "build or load" in native.build_error()
    # the Python backend is still there when asked for by name
    assert resolve_backend("python") == "python"


def test_auto_runs_python_only_without_a_compiler(monkeypatch, capsys):
    monkeypatch.setattr(native, "_compiler", lambda: None)
    monkeypatch.setattr(native, "_ENGINE", native.NativeEngine())
    assert not native.available()
    assert native.build_error() == "no C++ compiler on PATH"
    assert resolve_backend("auto") == "python"
    assert resolve_backend("auto") == "python"
    assert capsys.readouterr().err.count("Python oracle") == 1
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        resolve_backend("native")
    tr, _ = _overloaded(0)
    res = schedulers.run_baseline(tr, 2, 8, "tiresias")
    assert isinstance(res, oracle.OracleSim) and res.done()
