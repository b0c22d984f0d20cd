"""Checkpoints (L6 aux) of the port: a rotating store of training state.

Counterpart of the JAX package's ``checkpoint.py``. There Orbax persists
a Flax ``TrainState``; neither can be imported here, so the port writes
its own format, one directory per step::

    <dir>/<step>/state.pt    torch.save of a dict of CPU tensors
    <dir>/<step>/meta.json   JSON scalars: hyperparameters, iteration,
                             window cursor, fitness
    <dir>/.crc/<step>.json   crc32 of each payload file (the sidecar)

``state.pt`` holds tensors nested in dicts and lists, with plain
numbers and strings beside them, and loads with
``torch.load(weights_only=True)``: no pickled class is ever run. What
goes in it is the caller's (:meth:`..experiment.Experiment
.save_checkpoint`).

A step is written into a temporary sibling directory and moved into
place with ``os.replace``; its sidecar is then written the same way,
outside the step directory, so a reader sees a whole step or none. A
crash between the two leaves a step without a sidecar, which restores
unchecked, as in JAX.

Saves are synchronous. The payload is on the host before it is written
and a step is tens of megabytes at most, so a background thread would
save little (the JAX store writes asynchronously on accelerators, where
Orbax offers it). :meth:`Checkpointer.wait` settles the sidecars, as
there.

JAX (Orbax) checkpoints do not load here: weights trained by the JAX
package come in as ``--weights x.npz`` (:func:`..models.convert
.load_npz`). The shrink-to-fit restore (``elastic_restore``,
``validate_shrunk_geometry``) waits for the data-parallel slice
(``ROADMAP.md`` queue 1, item 21).
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import zlib

import torch

STATE_FILE = "state.pt"
META_FILE = "meta.json"


class CheckpointRestoreError(RuntimeError):
    """Every retained checkpoint step failed to restore (corruption or
    truncation across the whole rotation window)."""


class CheckpointChecksumError(RuntimeError):
    """A step's crc32 sidecar disagrees with its payload on disk (a torn
    write or a truncation, caught before deserializing)."""


def _sidecar_path(directory: str, step: int) -> str:
    # outside the step dir, so that a step directory holds its payload
    # and nothing else; .crc/ is pruned by Checkpointer.wait()
    return os.path.join(directory, ".crc", f"{step}.json")


def _step_payload_files(directory: str, step: int) -> list[str]:
    """Every file of checkpoint ``step``, as step-dir-relative paths
    (sorted for a stable sidecar)."""
    step_dir = os.path.join(directory, str(step))
    out = []
    for root, _dirs, files in os.walk(step_dir):
        for f in files:
            out.append(os.path.relpath(os.path.join(root, f), step_dir))
    return sorted(out)


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc


def _write_json_atomic(path: str, obj) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def write_checksum_sidecar(directory: str, step: int) -> dict[str, int]:
    """Compute ``{relpath: crc32}`` over checkpoint ``step``'s files and
    write the ``.crc/<step>.json`` sidecar atomically."""
    sums = {rel: _crc32_file(os.path.join(directory, str(step), rel))
            for rel in _step_payload_files(directory, step)}
    path = _sidecar_path(directory, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _write_json_atomic(path, sums)
    return sums


class Checkpointer:
    """Rotating checkpoint store for one training run.

    >>> ckpt = Checkpointer(dir, max_to_keep=3)
    >>> ckpt.save(step, {"policy": net.state_dict()}, meta={"lr": 3e-4})
    >>> state, meta = ckpt.restore(map_location="cuda")

    ``bus`` (an :class:`.obs.EventBus`) gets the JAX store's events:
    ``ckpt_save`` per written step, ``ckpt_restore`` per restore (with
    the step it fell back from), and ``ckpt_crc_reject`` or
    ``ckpt_reject`` per step the integrity fallback skipped.
    """

    def __init__(self, directory: str, max_to_keep: int | None = 3,
                 bus=None):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1 or None, got "
                             f"{max_to_keep}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.last_restored_step: int | None = None
        self._bus = bus

    def _emit(self, kind: str, **fields) -> None:
        if self._bus is not None:
            self._bus.emit(kind, **fields)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(self._step_dir(n)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict, meta: dict | None = None,
             force: bool = False) -> bool:
        """Persist checkpoint ``step``: ``state`` a dict of tensors (any
        device; they are written as they load, so pass host copies to
        keep the file device-free), ``meta`` a flat dict of JSON
        scalars. Returns False, writing nothing, when the step exists
        and ``force`` is not set; ``force=True`` overwrites it. The
        oldest steps beyond ``max_to_keep`` are then deleted (never the
        one just written)."""
        step = int(step)
        final = self._step_dir(step)
        if os.path.exists(final) and not force:
            return False
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(dict(meta or {}), f)
        if os.path.exists(final):
            # drop the old sidecar first: a crash mid-swap then leaves a
            # step without a sidecar, never one checked against the old
            try:
                os.unlink(_sidecar_path(self.directory, step))
            except FileNotFoundError:
                pass
            old = os.path.join(self.directory, f".old-{step}-{os.getpid()}")
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)
        write_checksum_sidecar(self.directory, step)
        if self.max_to_keep is not None:
            older = [s for s in self.all_steps() if s != step]
            for s in older[:max(len(older) + 1 - self.max_to_keep, 0)]:
                shutil.rmtree(self._step_dir(s))
        self.wait()
        self._emit("ckpt_save", step=step, force=force, saved=True)
        return True

    def restore(self, step: int | None = None,
                map_location: "torch.device | str | None" = None,
                ) -> tuple[dict, dict]:
        """Load a checkpoint: returns ``(state, meta)``, the tensors on
        ``map_location``.

        Integrity fallback: with ``step=None`` the retained steps are
        tried newest first. A step whose crc32 disagrees with its
        sidecar, or that fails to load, is reported on stderr and the
        next older one is tried; :class:`CheckpointRestoreError` is
        raised only when every step fails. An explicit ``step`` restores
        exactly that step and re-raises its failure.
        ``last_restored_step`` records the step that loaded. An empty
        directory raises ``FileNotFoundError``."""
        candidates = ([int(step)] if step is not None
                      else sorted(self.all_steps(), reverse=True))
        if not candidates:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        errors: list[tuple[int, Exception]] = []
        for i, s in enumerate(candidates):
            try:
                self._verify_checksums(s)
                state = torch.load(os.path.join(self._step_dir(s),
                                                STATE_FILE),
                                   map_location=map_location,
                                   weights_only=True)
                meta = self._load_meta(s)
            except Exception as e:   # a torn file fails in many ways
                errors.append((s, e))
                self._emit("ckpt_crc_reject"
                           if isinstance(e, CheckpointChecksumError)
                           else "ckpt_reject",
                           step=s, error=type(e).__name__,
                           detail=str(e)[:200])
                if step is not None:
                    raise
                if i + 1 < len(candidates):
                    print(f"checkpoint: step {s} failed to restore "
                          f"({type(e).__name__}: {str(e)[:200]}); "
                          f"falling back to step {candidates[i + 1]}",
                          file=sys.stderr, flush=True)
                continue
            self.last_restored_step = s
            self._emit("ckpt_restore", step=s,
                       fallback_from=(candidates[0] if i else None),
                       rejected=len(errors))
            return state, meta
        raise CheckpointRestoreError(
            f"all {len(candidates)} retained checkpoint steps under "
            f"{self.directory} failed to restore: "
            + "; ".join(f"step {s}: {type(e).__name__}"
                        for s, e in errors)) from errors[-1][1]

    def _load_meta(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), META_FILE)) as f:
            return dict(json.load(f))

    def _verify_checksums(self, step: int) -> None:
        """Compare checkpoint ``step``'s files with its crc32 sidecar. A
        step without a sidecar passes (the load itself still has to
        succeed)."""
        try:
            with open(_sidecar_path(self.directory, step)) as f:
                expected = json.load(f)
        except FileNotFoundError:
            return
        for rel, crc in expected.items():
            full = os.path.join(self._step_dir(step), rel)
            try:
                actual = _crc32_file(full)
            except FileNotFoundError as e:
                raise CheckpointChecksumError(
                    f"checkpoint step {step}: payload file {rel} named in "
                    f"the checksum sidecar is missing") from e
            if actual != crc:
                raise CheckpointChecksumError(
                    f"checkpoint step {step}: crc32 mismatch on {rel} "
                    f"(sidecar {crc:#010x}, on disk {actual:#010x})")

    def read_meta(self, step: int | None = None) -> dict:
        """A checkpoint's JSON meta without loading its tensors (e.g. the
        bar a resumed ``--keep-best`` run recovers)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        return self._load_meta(step)

    def wait(self) -> None:
        """Settle the crc32 sidecars: write one for every retained step
        that lacks it and delete those whose step was rotated out. Saves
        are synchronous, so nothing else is pending."""
        steps = set(self.all_steps())
        for s in steps:
            if not os.path.exists(_sidecar_path(self.directory, s)):
                write_checksum_sidecar(self.directory, s)
        crc_dir = os.path.join(self.directory, ".crc")
        if os.path.isdir(crc_dir):
            for name in os.listdir(crc_dir):
                stem = name.partition(".")[0]
                if name.endswith(".json") and stem.isdigit() \
                        and int(stem) not in steps:
                    os.unlink(os.path.join(crc_dir, name))

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
