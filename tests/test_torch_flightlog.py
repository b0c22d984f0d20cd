"""The port's flight log (``flywheel/flightlog.py``) against the JAX
package's, and its crash contract on its own.

- The same seeded rows (a flat column set and a dict tree) written by
  both writers give shards with the same column names, equal arrays and
  the same ``policy_step`` and row counts; each package reads the
  other's log back equal.
- The port's counterparts of the JAX cases: the ``req_id`` column, a
  shard written before it, the row accounting, the seal event, the torn
  tail against interior corruption, a missing interior shard or
  sidecar, a lost sealed tail, temp leftovers, the capacity check, the
  empty log.

No JAX program runs: the JAX flight log is numpy and files.
"""
import json
import os

import numpy as np
import pytest

from rlgpuschedule_tpu.flywheel import flightlog as jfl
from rlgpuschedule_tpu_torch.checkpoint import _crc32_file
from rlgpuschedule_tpu_torch.flywheel import flightlog as tfl
from rlgpuschedule_tpu_torch.flywheel.flightlog import (
    FlightLogCorruptError, FlightLogError, FlightLogWriter, read_flight_log,
    shard_name, unflatten_like)
from rlgpuschedule_tpu_torch.obs import EventBus, Registry, read_events


def synth_rows(n, seed=0, n_feat=5, n_act=7):
    """Single-leaf flight-log columns from a numpy seed."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n_feat)).astype(np.float32),
            rng.integers(0, 2, (n, n_act)).astype(bool),
            rng.integers(0, n_act, n).astype(np.int32),
            rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            rng.integers(0, 9, n).astype(np.int32),
            rng.integers(0, 3, n).astype(np.int8))


def tree_rows(n, seed=1):
    """Config-5-shaped dict rows: ``pods`` before ``top`` in sorted order,
    inserted the other way round."""
    rng = np.random.default_rng(seed)
    obs = {"top": rng.standard_normal((n, 6)).astype(np.float32),
           "pods": rng.standard_normal((n, 4, 3)).astype(np.float32)}
    mask = {"top": rng.random((n, 5)) < 0.7,
            "pods": rng.random((n, 4, 9)) < 0.7}
    act = {"top": rng.integers(0, 5, n).astype(np.int32),
           "pods": rng.integers(0, 9, (n, 4)).astype(np.int32)}
    lp = rng.standard_normal(n).astype(np.float32)
    val = rng.standard_normal(n).astype(np.float32)
    return (obs, mask, act, lp, val, np.zeros(n, np.int32),
            rng.integers(0, 3, n).astype(np.int8))


BATCHES = ((0, 7), (7, 14), (14, 20))


def _write(mod, directory, rows, capacity=8, req=True, **kw):
    """Uneven batches, so that seals straddle append boundaries."""
    obs, mask, act, lp, val, stall, oc = rows
    n = lp.shape[0]
    rids = np.arange(1, n + 1, dtype=np.int64) << 40
    take = lambda t, lo, hi: (
        {k: v[lo:hi] for k, v in t.items()} if isinstance(t, dict)
        else t[lo:hi])
    with mod.FlightLogWriter(directory, capacity=capacity, **kw) as w:
        for lo, hi in BATCHES:
            w.append_batch(take(obs, lo, hi), take(mask, lo, hi),
                           take(act, lo, hi), lp[lo:hi], val[lo:hi],
                           stall[lo:hi], oc[lo:hi],
                           req_id=rids[lo:hi] if req else None)
    return rids


def _shard_dict(s):
    return {"seq": s.seq, "rows": s.rows, "policy_step": s.policy_step,
            "obs": s.obs_leaves, "mask": s.mask_leaves,
            "act": s.act_leaves, "log_prob": s.log_prob, "value": s.value,
            "stall": s.stall, "outcome": s.outcome, "req_id": s.req_id}


def _assert_same_shards(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        dx, dy = _shard_dict(x), _shard_dict(y)
        for k in dx:
            if isinstance(dx[k], list):
                assert len(dx[k]) == len(dy[k]), k
                for u, v in zip(dx[k], dy[k]):
                    assert u.dtype == v.dtype, k
                    np.testing.assert_array_equal(u, v, err_msg=k)
            elif isinstance(dx[k], np.ndarray):
                assert dx[k].dtype == dy[k].dtype, k
                np.testing.assert_array_equal(dx[k], dy[k], err_msg=k)
            else:
                assert dx[k] == dy[k], k


@pytest.mark.parametrize("rows_of", ["flat", "tree"])
def test_both_writers_write_the_same_shards(tmp_path, rows_of):
    rows = synth_rows(20) if rows_of == "flat" else tree_rows(20)
    _write(jfl, str(tmp_path / "jax"), rows, policy_step=17)
    _write(tfl, str(tmp_path / "port"), rows, policy_step=17)
    for seq in range(3):
        with np.load(tmp_path / "jax" / shard_name(seq)) as zj, \
                np.load(tmp_path / "port" / shard_name(seq)) as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for k in zj.files:
                assert zj[k].dtype == zt[k].dtype, k
                np.testing.assert_array_equal(zj[k], zt[k], err_msg=k)
        sj, st = (json.load(open(tmp_path / side / ".crc"
                                 / f"shard-{seq:06d}.json"))
                  for side in ("jax", "port"))
        assert {k: sj[k] for k in ("file", "rows", "policy_step")} == \
            {k: st[k] for k in ("file", "rows", "policy_step")}
    if rows_of == "tree":
        cat = read_flight_log(str(tmp_path / "port")).concat()
        got = unflatten_like(rows[0], cat.obs_leaves)
        assert list(got) == ["top", "pods"]        # the example's order
        for k in got:
            np.testing.assert_array_equal(got[k], rows[0][k])


@pytest.mark.parametrize("rows_of", ["flat", "tree"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_reads_the_others_log(tmp_path, rows_of, writer,
                                          reader):
    rows = synth_rows(20) if rows_of == "flat" else tree_rows(20)
    mods = {"jax": jfl, "port": tfl}
    d = str(tmp_path / "log")
    _write(mods[writer], d, rows, policy_step=3)
    got = mods[reader].read_flight_log(d)
    want = mods[writer].read_flight_log(d)
    assert not got.torn_tail and got.rows == want.rows == 20
    _assert_same_shards(got.shards, want.shards)
    _assert_same_shards([got.concat()], [want.concat()])


def test_roundtrip_counts_and_metrics(tmp_path):
    d = str(tmp_path / "flog")
    reg = Registry()
    rows = synth_rows(20)
    _write(tfl, d, rows, policy_step=17, registry=reg, req=False)
    data = read_flight_log(d)
    assert not data.torn_tail
    assert [s.rows for s in data.shards] == [8, 8, 4]
    assert all(s.policy_step == 17 for s in data.shards)
    cat = data.concat()
    for got, want in zip((cat.obs_leaves[0], cat.mask_leaves[0],
                          cat.act_leaves[0], cat.log_prob, cat.value,
                          cat.stall, cat.outcome), rows):
        np.testing.assert_array_equal(got, want)
    assert cat.policy_step == 17
    rendered = reg.render()
    assert "flywheel_rows_logged_total 20" in rendered
    assert "flywheel_shards_sealed_total 3" in rendered


def test_req_id_round_trips_and_defaults_to_zero(tmp_path):
    rids = _write(tfl, str(tmp_path / "a"), synth_rows(20))
    cat = read_flight_log(str(tmp_path / "a")).concat()
    assert cat.req_id.dtype == np.int64
    np.testing.assert_array_equal(cat.req_id, rids)
    _write(tfl, str(tmp_path / "b"), synth_rows(20), req=False)
    np.testing.assert_array_equal(
        read_flight_log(str(tmp_path / "b")).concat().req_id,
        np.zeros(20, np.int64))


def test_a_shard_without_req_id_loads_with_zero_ids(tmp_path):
    d = str(tmp_path)
    obs, mask, act, lp, val, stall, oc = synth_rows(16)
    rids = np.arange(100, 116, dtype=np.int64)
    with FlightLogWriter(d, capacity=8) as w:
        w.append_batch(obs, mask, act, lp, val, stall, oc, req_id=rids)
    # shard 0 rewritten without the column, as an older writer left it,
    # and its sidecar blessed again
    path = os.path.join(d, shard_name(0))
    with np.load(path) as z:
        cols = {k: z[k] for k in z.files if k != "req_id"}
    with open(path, "wb") as f:
        np.savez(f, **cols)
    side = os.path.join(d, ".crc", "shard-000000.json")
    meta = json.load(open(side))
    meta["crc32"] = _crc32_file(path)
    json.dump(meta, open(side, "w"))
    for reader in (tfl.read_flight_log, jfl.read_flight_log):
        np.testing.assert_array_equal(
            reader(d).concat().req_id,
            np.concatenate([np.zeros(8, np.int64), rids[8:]]))


def test_req_id_length_mismatch_rejected(tmp_path):
    obs, mask, act, lp, val, stall, oc = synth_rows(4)
    with FlightLogWriter(str(tmp_path), capacity=8) as w:
        with pytest.raises(ValueError, match="req_id"):
            w.append_batch(obs, mask, act, lp, val, stall, oc,
                           req_id=np.arange(3, dtype=np.int64))


def test_rows_logged_counts_sealed_plus_buffered(tmp_path):
    obs, mask, act, lp, val, stall, oc = synth_rows(5)
    w = FlightLogWriter(str(tmp_path), capacity=4)
    w.append_batch(obs, mask, act, lp, val, stall, oc)
    assert w.rows_logged == 5 and w.shards_sealed == 1
    w.close()
    assert w.shards_sealed == 2       # the tail sealed on close
    with pytest.raises(FlightLogError, match="closed"):
        w.append_batch(obs, mask, act, lp, val, stall, oc)
    w.close()                         # idempotent


def test_seal_event_names_the_shard(tmp_path):
    bus = EventBus(str(tmp_path / "obs"))
    try:
        _write(tfl, str(tmp_path / "flog"), synth_rows(20), policy_step=3,
               bus=bus)
    finally:
        bus.close()
    seals = [e for e in read_events(bus.path)
             if e["kind"] == "flywheel_shard_seal"]
    assert [e["shard"] for e in seals] == [0, 1, 2]
    assert [e["rows"] for e in seals] == [8, 8, 4]
    assert all(e["policy_step"] == 3 for e in seals)


def _log(tmp_path):
    d = str(tmp_path)
    _write(tfl, d, synth_rows(20))
    return d


def _remove(d, *names):
    for n in names:
        os.remove(os.path.join(d, n))


@pytest.mark.parametrize("damage", ["missing-sidecar", "truncated"])
def test_torn_tail_dropped_and_flagged(tmp_path, damage):
    d = _log(tmp_path)
    if damage == "missing-sidecar":
        _remove(d, os.path.join(".crc", "shard-000002.json"))
    else:
        path = os.path.join(d, shard_name(2))
        blob = open(path, "rb").read()
        open(path, "wb").write(blob[:len(blob) // 2])
    for reader in (tfl.read_flight_log, jfl.read_flight_log):
        data = reader(d)
        assert data.torn_tail and "shard-000002" in data.torn_reason
        assert [s.seq for s in data.shards] == [0, 1] and data.rows == 16


@pytest.mark.parametrize("damage,match", [
    ("flipped-byte", "crc32 mismatch"),
    ("missing-interior-sidecar", "non-tail"),
    ("missing-interior-shard", "missing"),
    ("lost-sealed-tail", "lost")])
def test_interior_damage_raises(tmp_path, damage, match):
    d = _log(tmp_path)
    if damage == "flipped-byte":
        path = os.path.join(d, shard_name(0))
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(path, "wb").write(bytes(blob))
    elif damage == "missing-interior-sidecar":
        _remove(d, os.path.join(".crc", "shard-000001.json"))
    elif damage == "missing-interior-shard":
        _remove(d, shard_name(1), os.path.join(".crc", "shard-000001.json"))
    else:
        _remove(d, shard_name(2))
    with pytest.raises(FlightLogCorruptError, match=match):
        read_flight_log(d)
    with pytest.raises(jfl.FlightLogCorruptError, match=match):
        jfl.read_flight_log(d)


def test_tmp_leftovers_ignored(tmp_path):
    d = str(tmp_path)
    with FlightLogWriter(d, capacity=8) as w:
        w.append_batch(*synth_rows(8))
    open(os.path.join(d, "shard-000001.npz.tmp.999"), "wb").write(b"x")
    data = read_flight_log(d)
    assert not data.torn_tail and data.rows == 8


def test_capacity_validates(tmp_path):
    with pytest.raises(ValueError, match="capacity"):
        FlightLogWriter(str(tmp_path), capacity=0)


def test_empty_log_refuses_concat(tmp_path):
    data = read_flight_log(str(tmp_path))
    assert data.shards == [] and not data.torn_tail
    with pytest.raises(FlightLogError, match="empty"):
        data.concat()


def test_unflatten_like_keeps_none_and_counts_leaves():
    leaves = [np.zeros(2), np.ones(2)]
    got = unflatten_like({"b": None, "a": (0, 1)}, leaves)
    assert got["b"] is None and list(got) == ["b", "a"]
    assert got["a"][0] is leaves[0] and got["a"][1] is leaves[1]
    with pytest.raises(ValueError, match="more leaves"):
        unflatten_like({"a": 0}, leaves)
