"""Native baseline engine (L1, host C++): ``fast_oracle.cpp`` compiled on
first use with the system C++ compiler and bound with ``ctypes``.

The port's counterpart of the JAX package's ``native/``, with its own
copy of the source and the same C ABI. The engine replays the four
baseline schedulers of :mod:`..sim.schedulers` with the oracle's exact
semantics, far faster than the Python oracle on long traces. It runs
on the host; it is not a GPU kernel.

The shared library is built with ``<c++> -O2 -std=c++17 -shared -fPIC``
and cached by source hash in a user-owned 0700 directory,
``$XDG_CACHE_HOME/rlgpuschedule_tpu_torch`` (default
``~/.cache/rlgpuschedule_tpu_torch``), as
``fast_oracle_<sha256[:16]>.so``; never in the shared tmp directory,
where another local user could plant a library. With no compiler on
``PATH`` the engine is unavailable (:func:`available` is False and
:func:`build_error` says why). With a compiler present, a failed build
or load raises :class:`NativeBuildError`: there is no quiet fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np

from ..sim.oracle import DONE

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "fast_oracle.cpp")
_POLICIES = {"fifo": 0, "sjf": 1, "srtf": 2, "tiresias": 3}
_TIRESIAS_THRESHOLDS = (3600.0, 36000.0)   # sim.schedulers.TIRESIAS_THRESHOLDS
_ERRORS = {-1: "invalid input (zero/oversized gang or duration)",
           -2: "scheduler deadlock", -3: "no progress",
           -4: "max_events exceeded"}


class NativeBuildError(RuntimeError):
    """A C++ compiler is present but the engine did not build or load."""


def _compiler() -> str | None:
    return shutil.which("g++") or shutil.which("c++") or \
        shutil.which("clang++")


def cache_dir() -> str:
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "rlgpuschedule_tpu_torch")


class NativeEngine:
    """One build of one engine source. Nothing happens at construction;
    the library is built (or found in the cache) and loaded on the first
    call that needs it, once."""

    def __init__(self, src: str = SRC):
        self.src = src
        self._lib: ctypes.CDLL | None = None
        self._error: str | None = None   # why it is unavailable
        self._failed: NativeBuildError | None = None
        self._warned = False

    def so_path(self) -> str:
        d = cache_dir()
        os.makedirs(d, mode=0o700, exist_ok=True)
        with open(self.src, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        return os.path.join(d, f"fast_oracle_{tag}.so")

    def load(self) -> ctypes.CDLL | None:
        """The loaded library, or None when no compiler is on ``PATH``.
        Raises :class:`NativeBuildError` when a present compiler fails
        to build it or the result does not load."""
        if self._failed is not None:
            raise self._failed
        if self._lib is not None or self._error is not None:
            return self._lib
        cxx = _compiler()
        if cxx is None:
            self._error = "no C++ compiler on PATH"
            return None
        try:
            self._lib = self._build_and_bind(cxx)
        except (subprocess.SubprocessError, OSError) as e:
            detail = getattr(e, "stderr", None) or e
            self._error = f"build or load of {self.src} failed: {detail}"
            self._failed = NativeBuildError(self._error)
            raise self._failed from e
        return self._lib

    def _build_and_bind(self, cxx: str) -> ctypes.CDLL:
        so = self.so_path()
        if not os.path.exists(so):
            tmp = so + f".tmp{os.getpid()}"
            subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                            self.src, "-o", tmp],
                           check=True, capture_output=True, text=True,
                           timeout=120)
            os.replace(tmp, so)   # atomic: concurrent builds race safely
        lib = ctypes.CDLL(so)
        f = lib.run_baseline_native
        f.restype = ctypes.c_int64
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f.argtypes = [ctypes.c_int, f64, f64, i32, ctypes.c_int,
                      ctypes.c_int, f64, ctypes.c_int, f64, f64]
        return lib

    def warn_python_fallback(self) -> None:
        if not self._warned:
            self._warned = True
            print(f"note: {self._error}; the baselines run on the Python "
                  f"oracle (same schedule, slower)", file=sys.stderr)


_ENGINE = NativeEngine()


def available() -> bool:
    """True iff the engine is built and loaded; False only when no C++
    compiler is on ``PATH``. Raises :class:`NativeBuildError` when a
    compiler is present and the build or load fails."""
    return _ENGINE.load() is not None


def build_error() -> str | None:
    """Why the engine is unavailable, or None when it is loaded."""
    try:
        _ENGINE.load()
    except NativeBuildError:
        pass
    return _ENGINE._error


def warn_python_fallback() -> None:
    """Say once on stderr that the baselines run on the Python oracle."""
    _ENGINE.warn_python_fallback()


def run_baseline_native(trace, n_nodes: int, gpus_per_node: int, name: str,
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Run one named baseline natively over an ArrayTrace; returns per-row
    ``(finish, start)`` times ``[max_jobs]`` (+inf on padding; ``start``
    is the first start, kept across preemptions, as ``OracleSim.start``).
    Raises RuntimeError if the engine is unavailable or the trace is
    infeasible."""
    lib = _ENGINE.load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_ENGINE._error}")
    if name not in _POLICIES:
        raise ValueError(f"unknown baseline {name!r}")
    valid = np.flatnonzero(trace.valid)
    submit = np.ascontiguousarray(trace.submit[valid], np.float64)
    duration = np.ascontiguousarray(trace.duration[valid], np.float64)
    gpus = np.ascontiguousarray(trace.gpus[valid], np.int32)
    th = np.ascontiguousarray(_TIRESIAS_THRESHOLDS, np.float64)
    finish = np.full(len(valid), np.inf, np.float64)
    start = np.full(len(valid), np.inf, np.float64)
    rc = lib.run_baseline_native(
        len(valid), submit, duration, gpus, n_nodes * gpus_per_node,
        _POLICIES[name], th, len(th), finish, start)
    if rc < 0:
        raise RuntimeError(f"native {name} failed: "
                           f"{_ERRORS.get(int(rc), rc)}")
    finish_out = np.full(trace.max_jobs, np.inf, np.float64)
    start_out = np.full(trace.max_jobs, np.inf, np.float64)
    finish_out[valid] = finish
    start_out[valid] = start
    return finish_out, start_out


class NativeSimResult:
    """A finished native run with the ``OracleSim`` result surface
    (``sim.schedulers.BaselineResult``): ``finish``, ``start``,
    ``status``, ``jcts()``, ``avg_jct()``, ``trace``. Every row is DONE:
    valid jobs because the engine runs the trace to completion, padding
    rows because the oracle marks them DONE from the start."""

    def __init__(self, trace, finish: np.ndarray, start: np.ndarray):
        self.trace = trace
        self.finish = np.where(np.isfinite(finish), finish, np.nan)
        self.start = np.where(np.isfinite(start), start, np.nan)
        self.status = np.full(trace.max_jobs, DONE, np.int32)

    def jcts(self) -> np.ndarray:
        v = self.trace.valid & np.isfinite(self.finish)
        return (self.finish[v] - self.trace.submit[v]).astype(np.float64)

    def avg_jct(self) -> float:
        j = self.jcts()
        return float(j.mean()) if len(j) else float("nan")
