"""Parity of the port's actor-critics with the JAX package's.

Weights come from a JAX ``make_policy(...).init`` through
``params_from_jax``; the same numpy inputs go through both networks.
Logits and value must agree within atol = rtol = 1e-5 at float32 and
within 2e-2 at bfloat16 (Flax and torch round bf16 at slightly
different points inside a layer). The grid cases use one even and one
odd image height, so Flax's asymmetric ``SAME`` padding is exercised on
both branches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu_torch.models import (load_npz, make_policy,
                                            params_from_jax)
from rlgpuschedule_tpu_torch.models.encoders import same_padding

# the tensors here are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

B = 6
SHAPES = {"flat": (8 + 4 * 4 + 2,), "grid12": (12, 4, 2), "grid13": (13, 4, 2)}
N_ACTIONS = 5


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.random((B,) + shape, dtype=np.float32)
    mask = rng.random((B, N_ACTIONS)) < 0.6
    mask[:, -1] = True
    return obs, mask


def _pair(key, dtype_j, dtype_t, policy_gain=1.0):
    kind = "flat" if key == "flat" else "grid"
    obs, mask = _inputs(SHAPES[key])
    jnet = jmake_policy(kind, N_ACTIONS, dtype=dtype_j)
    params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(1), obs,
                                               mask))
    head = params["params"]["policy"]
    head["kernel"] = np.asarray(head["kernel"]) * np.float32(policy_gain)
    tnet = make_policy(kind, N_ACTIONS, SHAPES[key], dtype=dtype_t,
                       device="cpu")
    tnet.load_state_dict(params_from_jax(params))
    return jnet, params, tnet, obs, mask


@pytest.mark.parametrize("key", sorted(SHAPES))
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_logits_and_value_match_jax(key, dtype, tol):
    # the 0.01-gain policy head of a fresh init gives logits of about
    # 5e-3, which a 2e-2 tolerance could not tell from zero; scaled by
    # 100 they are O(1), as a trained policy's are
    jnet, params, tnet, obs, mask = _pair(key, getattr(jnp, dtype),
                                          getattr(torch, dtype),
                                          policy_gain=100.0)
    jl, jv = jax.jit(jnet.apply)(params, obs, mask)
    with torch.no_grad():
        tl, tv = tnet(torch.from_numpy(obs), torch.from_numpy(mask))
    assert tl.dtype == torch.float32 and tv.dtype == torch.float32
    jl = np.asarray(jl)
    legal = np.abs(jl[mask])
    assert legal.max() > 10 * tol, "the logits are too small to compare"
    np.testing.assert_allclose(tl.numpy(), jl, rtol=tol, atol=tol)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=tol, atol=tol)
    # the greedy choice agrees wherever the JAX top-two margin is wider
    # than the tolerance allows the two to move apart
    top2 = np.sort(jl, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol * (1 + np.abs(top2[:, 1]))
    assert clear.any()
    np.testing.assert_array_equal(tl.numpy().argmax(-1)[clear],
                                  jl.argmax(-1)[clear])
    # the masked actions carry exactly the -1e9 mask value
    np.testing.assert_array_equal(tl.numpy()[~mask], np.float32(-1e9))


def test_same_padding_matches_flax_on_both_branches():
    assert same_padding(80, 2, 3) == (0, 1)   # config 2's 80 rows
    assert same_padding(13, 2, 3) == (1, 1)
    assert same_padding(8, 1, 3) == (1, 1)


def test_config2_network_has_the_reference_parameter_count():
    net = make_policy("grid", 17, (80, 8, 2), device="cpu")
    assert sum(p.numel() for p in net.parameters()) == 2_683_186
    assert tuple(net.encoder.Dense_0.weight.shape) == (256, 10240)


@pytest.mark.parametrize("key", ["flat", "grid13"])
def test_init_draws_from_the_flax_distributions(key):
    kind = "flat" if key == "flat" else "grid"
    net = make_policy(kind, N_ACTIONS, SHAPES[key], device="cpu", seed=3)
    again = make_policy(kind, N_ACTIONS, SHAPES[key], device="cpu", seed=3)
    for (name, p), q in zip(net.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(p, q), f"{name} is not a function of the seed"
    for name, p in net.state_dict().items():
        if name.endswith("bias"):
            assert not p.any(), name
        elif "LayerNorm" in name:
            assert (p == 1).all(), name
        elif name.startswith("encoder"):
            # lecun_normal: variance 1/fan_in, truncated at 2 std of the
            # underlying normal
            std = (1.0 / p[0].numel()) ** 0.5
            assert p.abs().max() <= 2 * std / 0.87962566103423978 + 1e-6
            assert abs(p.std().item() / std - 1) < 0.2, name
    for head, gain in ((net.policy, 0.01), (net.value, 1.0)):
        w = head.weight.detach().double()
        np.testing.assert_allclose((w @ w.T).numpy(),
                                   gain ** 2 * np.eye(w.shape[0]),
                                   atol=1e-6 * max(gain ** 2, 1e-4))


def test_convert_refuses_unmapped_leaves():
    _, params, _, _, _ = _pair("flat", jnp.float32, torch.float32)
    # a head no actor-critic of the port has
    params = {"params": dict(params["params"],
                             aux_policy={"kernel": np.zeros((4, 1))})}
    with pytest.raises(ValueError, match="aux_policy"):
        params_from_jax(params)


def test_load_npz_reads_the_flat_flax_tree(tmp_path):
    _, params, tnet, obs, mask = _pair("grid13", jnp.float32, torch.float32)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "w.npz", **flat)
    got = load_npz(str(tmp_path / "w.npz"))
    want = params_from_jax(params)
    assert set(got) == set(want) == set(tnet.state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k
