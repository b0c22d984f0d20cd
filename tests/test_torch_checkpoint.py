"""Checkpoints of the port: the store, the experiment's save and restore,
bit-for-bit resume, and ``select_checkpoint`` against the JAX package's.

- A save and a restore give back the same bits for every payload: the
  policy's parameters, both Adam moments and the Adam step (carried over
  from a JAX ``TrainState`` taken mid-run with ``params_from_jax`` and
  ``opt_state_from_jax``), the rollout carry, both generators' states
  and the meta.
- The store rotates to ``max_to_keep`` steps with one crc32 sidecar
  each, rejects a truncated payload by its crc and falls back to the
  step before, raises ``CheckpointRestoreError`` when every step fails,
  re-raises an explicit step's failure, overwrites with ``force`` and
  loads no pickled class.
- ``k`` iterations, a restore into a fresh ``Experiment`` and ``k``
  more equal ``2k`` uninterrupted iterations bit for bit, with static
  windows and with a window resample crossing the restore (the JAX
  tests ``TestExperimentResume``).
- ``select_checkpoint`` over the same weights saved at the same steps
  in both packages' formats ranks them as JAX's does, and refuses every
  seed JAX's refuses.
"""
import dataclasses
import functools
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlgpuschedule_tpu import checkpoint as jckpt
from rlgpuschedule_tpu import configs as jconfigs
from rlgpuschedule_tpu import experiment as jexp
from rlgpuschedule_tpu import select_checkpoint as jselect
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu_torch import configs as tconfigs
from rlgpuschedule_tpu_torch import experiment as texp
from rlgpuschedule_tpu_torch import select_checkpoint as tselect
from rlgpuschedule_tpu_torch.checkpoint import (CheckpointChecksumError,
                                                Checkpointer,
                                                CheckpointRestoreError,
                                                _crc32_file)
from rlgpuschedule_tpu_torch.experiment import Experiment
from rlgpuschedule_tpu_torch.models import opt_state_from_jax, params_from_jax
from torch_jax_builds import fast_jax_build, jitted_reference

# the tensors here are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

SMALL = dict(n_envs=2, n_nodes=4, gpus_per_node=4, window_jobs=12,
             queue_len=4, horizon=96)
SHAPE_FLAGS = ["--n-envs", "2", "--n-nodes", "4", "--gpus-per-node", "4",
               "--window-jobs", "12", "--queue-len", "4", "--horizon", "96"]


def _cfg(package=tconfigs, **kw):
    base = package.CONFIGS["ppo-mlp-synth64"]
    ppo = dataclasses.replace(base.ppo, n_steps=8, n_epochs=2,
                              n_minibatches=2)
    return dataclasses.replace(base, **SMALL, ppo=ppo, **kw)


def _adam(opt_state):
    return next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _assert_same_state(a: Experiment, b: Experiment):
    """Parameters, Adam moments and step, the carry and both generators
    of two experiments, bit for bit."""
    for (name, x), y in zip(a.net.state_dict().items(),
                            b.net.state_dict().values()):
        assert torch.equal(x, y), name
    sa = a.train_state.opt.state_dict()["state"]
    sb = b.train_state.opt.state_dict()["state"]
    assert sa.keys() == sb.keys() and sa
    for i in sa:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    for f, x, y in zip(a.carry.env_state.sim._fields, a.carry.env_state.sim,
                       b.carry.env_state.sim):
        assert torch.equal(x, y), f
    for f in ("obs", "mask"):
        assert torch.equal(getattr(a.carry, f), getattr(b.carry, f)), f
    assert torch.equal(a.carry.env_state.t, b.carry.env_state.t)
    assert torch.equal(a.carry.generator.get_state(),
                       b.carry.generator.get_state())
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.step == b.step and a.iteration == b.iteration
    assert a.window_cursor == b.window_cursor


# ---- save and restore -------------------------------------------------------

def test_save_restore_gives_the_same_bits_for_every_payload(tmp_path):
    """A JAX TrainState taken after 2 iterations (Adam count 8) moved into
    the port, trained one more iteration there, saved and restored into a
    fresh experiment: every payload comes back bit for bit."""
    ej = fast_jax_build(_cfg(jconfigs))
    ej.run(iterations=2)
    adam = jax.device_get(_adam(ej.train_state.opt_state))
    assert int(adam.count) == 2 * 2 * 2
    exp = Experiment.build(_cfg(), device="cpu")
    exp.net.load_state_dict(params_from_jax(jax.device_get(
        ej.train_state.params)))
    exp.train_state.opt.load_state_dict(opt_state_from_jax(
        adam.mu, adam.nu, adam.count, exp.net, exp.train_state.opt))
    exp.run(1)
    assert exp.step == 12
    with Checkpointer(str(tmp_path / "ck")) as ck:
        assert exp.save_checkpoint(ck, meta={"eval_avg_jct": 123.5})
        assert ck.all_steps() == [12]
        fresh = Experiment.build(_cfg(), device="cpu")
        meta = fresh.restore_checkpoint(ck)
    assert ck.last_restored_step == 12
    _assert_same_state(exp, fresh)
    assert meta["eval_avg_jct"] == 123.5
    assert meta["iteration"] == 0 and meta["window_cursor"] == 0
    assert meta["generator_device"] == "cpu"
    assert meta["config"] == json.loads(json.dumps(
        dataclasses.asdict(exp.cfg)))
    state = torch.load(tmp_path / "ck" / "12" / "state.pt",
                       weights_only=True)
    assert set(state) == {"policy", "optimizer", "carry", "generators"}
    assert all(t.device.type == "cpu" for t in state["policy"].values())


def test_restore_policy_only_across_generator_devices(tmp_path):
    """A checkpoint whose generators were drawn on another kind of device
    restores its policy (``train=False``, :func:`restore_policy`) but
    refuses to continue the run."""
    exp = Experiment.build(_cfg(), device="cpu")
    exp.run(1)
    with Checkpointer(str(tmp_path / "ck")) as ck:
        exp.save_checkpoint(ck)
        state, meta = ck.restore()
        ck.save(ck.latest_step(), state,
                dict(meta, generator_device="cuda"), force=True)
        fresh = Experiment.build(_cfg(), device="cpu")
        with pytest.raises(ValueError, match="train=False"):
            fresh.restore_checkpoint(ck)
        fresh.restore_checkpoint(ck, train=False)
        for (k, x), y in zip(exp.net.state_dict().items(),
                             fresh.net.state_dict().values()):
            assert torch.equal(x, y), k
        assert fresh.step == 0 and fresh.iteration == 0
        net = texp.build_policy(exp.cfg, exp.env_params, device="cpu")
        assert texp.restore_policy(ck, net)["generator_device"] == "cuda"
        assert torch.equal(net.state_dict()["policy.weight"],
                           exp.net.state_dict()["policy.weight"])


# ---- the store --------------------------------------------------------------

def _payload(v: float) -> dict:
    return {"w": torch.full((64, 64), v), "n": torch.tensor([int(v)])}


def _crcs(d):
    return sorted(os.listdir(os.path.join(d, ".crc")))


def test_rotation_keeps_max_to_keep_with_one_sidecar_each(tmp_path):
    d = str(tmp_path / "ck")
    with Checkpointer(d, max_to_keep=2) as ck:
        for s in range(1, 6):
            assert ck.save(s, _payload(s), meta={"s": s})
        assert ck.all_steps() == [4, 5] and ck.latest_step() == 5
        assert _crcs(d) == ["4.json", "5.json"]
        # a stale sidecar (its step gone) is pruned by wait()
        with open(os.path.join(d, ".crc", "99.json"), "w") as f:
            f.write("{}")
        ck.wait()
        assert _crcs(d) == ["4.json", "5.json"]
        assert ck.read_meta() == {"s": 5} and ck.read_meta(4) == {"s": 4}
    sums = json.load(open(os.path.join(d, ".crc", "5.json")))
    assert set(sums) == {"state.pt", "meta.json"}
    path = os.path.join(d, "5", "state.pt")
    with open(path, "rb") as f:
        assert sums["state.pt"] == zlib.crc32(f.read()) == _crc32_file(path)
    assert _crc32_file(path) == jckpt._crc32_file(path)


def test_truncated_payload_is_rejected_by_its_crc_and_falls_back(
        tmp_path, capsys):
    d = str(tmp_path / "ck")
    ck = Checkpointer(d, max_to_keep=3)
    for s in (1, 2, 3):
        ck.save(s, _payload(s))
    path = os.path.join(d, "3", "state.pt")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)
    state, _ = ck.restore()
    assert ck.last_restored_step == 2
    assert torch.equal(state["w"], torch.full((64, 64), 2.0))
    assert "step 3 failed to restore (CheckpointChecksumError" in \
        capsys.readouterr().err
    # an explicit step re-raises its own failure
    with pytest.raises(CheckpointChecksumError, match="crc32 mismatch"):
        ck.restore(step=3)
    # a step with no sidecar (a crash before it was written) that does
    # not load falls back too
    os.unlink(os.path.join(d, ".crc", "2.json"))
    with open(os.path.join(d, "2", "state.pt"), "wb") as f:
        f.write(b"torn")
    ck.restore()
    assert ck.last_restored_step == 1


def test_every_step_failing_raises_restore_error(tmp_path):
    d = str(tmp_path / "ck")
    ck = Checkpointer(d, max_to_keep=None)
    for s in (1, 2):
        ck.save(s, _payload(s))
        os.unlink(os.path.join(d, str(s), "meta.json"))
    with pytest.raises(CheckpointRestoreError,
                       match="all 2 retained checkpoint steps"):
        ck.restore()


def test_force_overwrites_and_a_plain_save_skips(tmp_path):
    d = str(tmp_path / "ck")
    with Checkpointer(d) as ck:
        assert ck.save(3, _payload(1.0), meta={"v": 1})
        assert not ck.save(3, _payload(9.0), meta={"v": 2})
        assert ck.read_meta(3) == {"v": 1}
        assert ck.save(3, _payload(9.0), meta={"v": 2}, force=True)
        state, meta = ck.restore()
        assert meta == {"v": 2}
        assert torch.equal(state["w"], torch.full((64, 64), 9.0))
        assert _crcs(d) == ["3.json"]
        assert not [n for n in os.listdir(d) if n.startswith(".")
                    and n != ".crc"], "a temporary directory was left"


def test_empty_dir_raises_file_not_found(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"))
    assert ck.all_steps() == [] and ck.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ck.restore()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ck.read_meta()
    with pytest.raises(ValueError, match="max_to_keep"):
        Checkpointer(str(tmp_path / "x"), max_to_keep=0)


def test_a_pickled_class_is_never_loaded(tmp_path):
    """``torch.load(weights_only=True)``: a payload holding an arbitrary
    object does not restore."""
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, {"cfg": tconfigs.CONFIGS["ppo-mlp-synth64"]})
    with pytest.raises(CheckpointRestoreError):
        ck.restore()


# ---- resume -----------------------------------------------------------------

@pytest.mark.parametrize("resample_every,drain_frac",
                         [(0, 0.0), (1, 0.5)],
                         ids=["static", "streaming"])
def test_resume_continues_identically(tmp_path, resample_every, drain_frac):
    """3 iterations, a save, 2 more; a fresh experiment restored from the
    save and run 2 iterations ends bit for bit where the uninterrupted
    one does (with streaming, on windows re-cut at every iteration)."""
    cfg = _cfg(resample_every=resample_every, drain_frac=drain_frac)
    exp = Experiment.build(cfg, device="cpu")
    exp.run(3)
    with Checkpointer(str(tmp_path / "ck")) as ck:
        exp.save_checkpoint(ck)
        exp.run(2)
        fresh = Experiment.build(cfg, device="cpu")
        meta = fresh.restore_checkpoint(ck)
    assert meta["window_cursor"] == fresh.window_cursor == \
        2 * cfg.n_envs * resample_every
    fresh.run(2)
    _assert_same_state(exp, fresh)
    if resample_every:
        assert exp.window_cursor == 4 * cfg.n_envs


def test_resume_from_a_checkpoint_on_a_resample_boundary(tmp_path):
    """Checkpoints every 2 iterations with a resample every 2: the
    iteration-2 checkpoint holds the state before the re-cut, and the
    restored run re-cuts first, as the uninterrupted one did."""
    cfg = _cfg(resample_every=2, drain_frac=0.5)
    exp = Experiment.build(cfg, device="cpu")
    with Checkpointer(str(tmp_path / "ck"), max_to_keep=3) as ck:
        out = exp.run(4, ckpt=ck, ckpt_every=2)
        assert out["window_cursor"] == cfg.n_envs
        steps = ck.all_steps()
        assert steps == [2 * 4, 4 * 4]   # iterations x epochs x minibatches
        fresh = Experiment.build(cfg, device="cpu")
        meta = fresh.restore_checkpoint(ck, step=steps[0])
    assert meta["iteration"] == 1 and meta["window_cursor"] == 0
    fresh.run(2)
    _assert_same_state(exp, fresh)


# ---- select_checkpoint ------------------------------------------------------

STEPS = (2, 4, 6)


def _weights(k: int) -> dict:
    """A JAX f32 init per step, its policy head scaled by 100 (decisive
    greedy choices)."""
    p = jax.tree.map(np.asarray, jax.jit(jmake_policy(
        "flat", 5, dtype=jnp.float32).init)(
        jax.random.PRNGKey(k), jnp.zeros((1, 22)), jnp.ones((1, 5), bool)))
    p["params"]["policy"]["kernel"] = p["params"]["policy"]["kernel"] * 100
    return p


def test_select_checkpoint_ranks_like_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(jexp, "make_policy", functools.partial(
        jmake_policy, dtype=jnp.float32))
    monkeypatch.setattr(texp, "build_policy", functools.partial(
        texp.build_policy, dtype=torch.float32))
    ej = fast_jax_build(_cfg(jconfigs))
    et = Experiment.build(_cfg(), device="cpu")
    with jckpt.Checkpointer(str(tmp_path / "jax")) as jck, \
            Checkpointer(str(tmp_path / "port")) as tck:
        for k in STEPS:
            w = _weights(k)
            ej.train_state = ej.train_state.replace(params=w)
            ej.save_checkpoint(jck, step=k)
            et.net.load_state_dict(params_from_jax(w))
            et.save_checkpoint(tck, step=k)
    argv = SHAPE_FLAGS + ["--val-jobs", "48", "--stitch-drain-jobs", "2"]
    with jitted_reference():
        want = jselect.main(["--ckpt-dir", str(tmp_path / "jax")] + argv)
    got = tselect.main(["--ckpt-dir", str(tmp_path / "port")] + argv
                       + ["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["step"] == got["step"] == want["step"]
    assert [s for _, s in got["ranking"]] == [s for _, s in want["ranking"]]
    np.testing.assert_allclose([r for r, _ in got["ranking"]],
                               [r for r, _ in want["ranking"]], atol=1e-4)
    assert got["val_tiresias"] == want["val_tiresias"]
    assert len({r for r, _ in got["ranking"]}) > 1, "no ranking to compare"


@pytest.mark.parametrize("argv,match", [
    (["--val-seed", "0"], "training seed"),
    (["--val-seed", "1000"], "seed \\+ 1000"),
    (["--seed", "5", "--val-seed", "1005"], "seed \\+ 1000"),
    (["--test-seed", "2000"], "disjoint"),
    (["--test-seed", "0"], "training seed"),
    (["--config", "csv-philly"], "csv traces"),
    (["--config", "nope"], "unknown config"),
])
def test_select_checkpoint_refuses_what_jax_refuses(tmp_path, monkeypatch,
                                                    argv, match):
    for pkg in (jconfigs, tconfigs):
        monkeypatch.setitem(pkg.CONFIGS, "csv-philly", dataclasses.replace(
            pkg.CONFIGS["ppo-mlp-synth64"], trace="philly"))
    for main in (jselect.main, tselect.main):
        with pytest.raises(SystemExit, match=match):
            main(["--ckpt-dir", str(tmp_path)] + argv)


def test_select_checkpoint_cli_has_jax_flags():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings
                if s.startswith("--") and s != "--help"}
    assert flags(tselect.build_parser()) - flags(jselect.build_parser()) \
        == {"--device"}
    assert flags(jselect.build_parser()) <= flags(tselect.build_parser())
