"""The port's RLSF framing (``rlgpuschedule_tpu_torch/serve/wire.py``)
against the JAX package's: every pack function gives the same bytes for
the same seeded rows (float32, bool and int32 leaves, and a dict tree),
each package's frames parse in the other (v2 and v1 prefixes), the
golden prefix bytes of ``tests/test_wire.py`` parse back, the blocking
reader reassembles split writes and tells a clean EOF from a truncation,
and the port's ``unpack_prefix`` refuses what JAX's refuses, in the same
words."""
import socket
import threading

import numpy as np
import pytest

from rlgpuschedule_tpu.serve import wire as jwire
from rlgpuschedule_tpu_torch.serve import wire as twire

PACKAGES = {"jax": jwire, "torch": twire}


def rows(seed=0):
    """Seeded request rows: float32 obs, bool mask, int32 stall-like
    leaf, and a dict tree whose keys are out of sorted order."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal(6).astype(np.float32)
    mask = rng.random(9) < 0.5
    ints = rng.integers(-1000, 1000, size=(2, 3)).astype(np.int32)
    tree = {"z": rng.standard_normal((2, 4)).astype(np.float32),
            "a": rng.random(5) < 0.5, "m": ints}
    return obs, mask, ints, tree


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_functions_give_jaxs_bytes(seed):
    obs, mask, ints, tree = rows(seed)
    for x in (obs, mask, ints, tree, {"only": obs}, (obs, mask)):
        assert twire.descriptor(x) == jwire.descriptor(x)
    assert twire.pack_frame(twire.KIND_REQ, b"hdr", b"body", meta64=7,
                            meta32=3, req_id=99) == jwire.pack_frame(
        jwire.KIND_REQ, b"hdr", b"body", meta64=7, meta32=3, req_id=99)
    for o, m in ((obs, mask), (tree, mask), (ints, {"b": mask, "a": obs})):
        for kw in ({}, {"deadline_s": 0.0123, "stall": 4, "req_id": 5},
                   {"deadline_s": 1e-9, "req_id": (1 << 63) - 1}):
            assert twire.pack_request(o, m, **kw) == \
                jwire.pack_request(o, m, **kw)
    for action in (np.int32(seed), ints, obs):
        assert twire.pack_response(action, 0.001234, req_id=seed) == \
            jwire.pack_response(action, 0.001234, req_id=seed)
    for reason, detail, retry in (("shed:admission", {"x": 1.5}, 0.25),
                                  ("closed", {"detail": "d"}, None),
                                  ("bad-request", {}, 1e-9)):
        assert twire.pack_error(reason, detail, retry, req_id=seed) == \
            jwire.pack_error(reason, detail, retry, req_id=seed)


def test_a_none_leaf_is_an_empty_subtree_as_in_jax():
    obs, mask, _, _ = rows()
    tree = {"a": obs, "none": None, "b": (mask, None)}
    assert twire.descriptor(tree) == jwire.descriptor(tree)
    assert twire.pack_request(tree, mask) == jwire.pack_request(tree, mask)


def _v1(pkg, kind, header, body, meta64=0, meta32=0):
    return pkg.PREFIX_V1.pack(pkg.MAGIC, 1, kind, len(header), len(body),
                              meta64, meta32) + header + body


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_each_packages_frames_parse_in_the_other(src, dst):
    s, d = PACKAGES[src], PACKAGES[dst]
    obs, mask, ints, _ = rows(3)
    frames = [
        (s.pack_request(obs, mask, deadline_s=0.05, stall=2, req_id=77),
         (d.KIND_REQ, 50_000, 2, 77)),
        (s.pack_response(ints, 0.5, req_id=8), (d.KIND_RESP, 500_000, 0, 8)),
        (s.pack_error("shed:expired", {"k": 1}, 0.02, req_id=9),
         (d.KIND_ERR, 20_000, 0, 9)),
        (_v1(s, s.KIND_REQ, b"float32:(6,)", obs.tobytes(), 11, 1),
         (d.KIND_REQ, 11, 1, 0)),
    ]
    for frame, (kind, meta64, meta32, rid) in frames:
        plen = (d.PREFIX_V1_SIZE if frame[4] == 1 else d.PREFIX_SIZE)
        k, hlen, blen, m64, m32, r = d.unpack_prefix(frame[:plen])
        assert (k, m64, m32, r) == (kind, meta64, meta32, rid)
        assert plen + hlen + blen == len(frame)
        a, b = socket.socketpair()
        try:
            a.sendall(frame)
            got = d.recv_frame(b)
        finally:
            a.close()
            b.close()
        assert got[0] == kind and got[5] == rid
        assert got[1] + got[2] == frame[plen:]
        if kind == d.KIND_RESP:
            np.testing.assert_array_equal(d.unpack_action(got[1], got[2]),
                                          ints)


class TestGoldenBytes:
    """``tests/test_wire.py``'s pinned v2 and v1 prefixes."""

    GOLDEN_PREFIX = (b"RLSF" b"\x02" b"\x01" b"\x04\x00"
                     b"\x0a\x00\x00\x00"
                     b"\x88\x77\x66\x55\x44\x33\x22\x11"
                     b"\xcc\xbb\xaa\x99"
                     b"\x78\x69\x5a\x4b\x3c\x2d\x1e\x0f")
    V1_PREFIX_PIN = (b"RLSF" b"\x01" b"\x01" b"\x04\x00"
                     b"\x0a\x00\x00\x00"
                     b"\x88\x77\x66\x55\x44\x33\x22\x11"
                     b"\xcc\xbb\xaa\x99")

    def test_the_port_packs_the_golden_prefix(self):
        frame = twire.pack_frame(twire.KIND_REQ, b"hdr!", b"body-bytes",
                                 meta64=0x1122334455667788,
                                 meta32=0x99AABBCC,
                                 req_id=0x0F1E2D3C4B5A6978)
        assert frame[:twire.PREFIX_SIZE] == self.GOLDEN_PREFIX
        assert frame[twire.PREFIX_SIZE:] == b"hdr!body-bytes"

    @pytest.mark.parametrize("pin,rid", [
        (GOLDEN_PREFIX, 0x0F1E2D3C4B5A6978), (V1_PREFIX_PIN, 0)])
    def test_golden_prefixes_parse_back(self, pin, rid):
        got = twire.unpack_prefix(pin)
        assert got == (twire.KIND_REQ, 4, 10, 0x1122334455667788,
                       0x99AABBCC, rid)
        assert got == jwire.unpack_prefix(pin)


class TestRecvFrame:
    def test_split_writes_reassemble(self):
        obs, mask, _, _ = rows(4)
        frames = [twire.pack_request(obs, mask, req_id=i + 1)
                  for i in range(3)]
        frames.append(_v1(twire, twire.KIND_REQ, b"h", b"bb"))
        blob = b"".join(frames)
        a, b = socket.socketpair()

        def trickle():
            # odd-sized chunks: every prefix, header and body is split
            for i in range(0, len(blob), 7):
                a.sendall(blob[i:i + 7])
            a.close()

        t = threading.Thread(target=trickle)
        t.start()
        try:
            for i in range(3):
                kind, header, body, _, _, rid = twire.recv_frame(b)
                assert kind == twire.KIND_REQ and rid == i + 1
                assert body == obs.tobytes() + mask.tobytes()
            assert twire.recv_frame(b)[1:3] == (b"h", b"bb")
            with pytest.raises(EOFError):
                twire.recv_frame(b)           # clean EOF at a boundary
        finally:
            t.join(timeout=10)
            b.close()

    @pytest.mark.parametrize("cut", [3, twire.PREFIX_V1_SIZE,
                                     twire.PREFIX_SIZE + 2, -1])
    def test_truncation_is_a_connection_error(self, cut):
        obs, mask, _, _ = rows(5)
        frame = twire.pack_request(obs, mask)
        a, b = socket.socketpair()
        a.sendall(frame[:cut])
        a.close()
        try:
            with pytest.raises(ConnectionError):
                twire.recv_frame(b)
        finally:
            b.close()


@pytest.mark.parametrize("mutate", [
    lambda b: b"XXXX" + b[4:],
    lambda b: b[:4] + bytes([99]) + b[5:],
    lambda b: b[:5] + bytes([0]) + b[6:],
    lambda b: b[:-1],
    lambda b: b[:24],
    lambda b: b[:24] + b"\x00",
    lambda b: jwire.PREFIX_V1.pack(jwire.MAGIC, 1, 9, 0, 0, 0, 0),
    lambda b: jwire.PREFIX.pack(jwire.MAGIC, jwire.VERSION, jwire.KIND_REQ,
                                0, jwire.MAX_BODY_BYTES + 1, 0, 0, 0),
], ids=["magic", "version", "kind", "short", "v2-as-v1", "odd-size",
        "v1-kind", "oversized"])
def test_unpack_prefix_refuses_what_jax_refuses(mutate):
    good = twire.pack_frame(twire.KIND_REQ, b"", b"")[:twire.PREFIX_SIZE]
    bad = mutate(good)
    with pytest.raises(jwire.WireError) as want:
        jwire.unpack_prefix(bad)
    with pytest.raises(twire.WireError) as got:
        twire.unpack_prefix(bad)
    assert str(got.value) == str(want.value)


def test_unpack_action_refuses_a_bad_descriptor():
    with pytest.raises(twire.WireError, match="bad action descriptor"):
        twire.unpack_action(b"notadtype:(2,)", b"\x00" * 8)
    with pytest.raises(twire.WireError):
        twire.unpack_action(b"int32:(3,)", b"\x00" * 8)   # wrong length


@pytest.mark.parametrize("kind,header,body", [
    (7, b"", b""), (twire.KIND_REQ, b"h" * 0x10000, b""),
    (twire.KIND_REQ, b"", b"\x00" * (twire.MAX_BODY_BYTES + 1))],
    ids=["kind", "header", "body"])
def test_pack_frame_refuses_what_jax_refuses(kind, header, body):
    with pytest.raises(jwire.WireError) as want:
        jwire.pack_frame(kind, header, body)
    with pytest.raises(twire.WireError) as got:
        twire.pack_frame(kind, header, body)
    assert str(got.value) == str(want.value)
