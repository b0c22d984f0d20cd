"""Parity of the port's GNN actor-critic with the JAX package's.

Weights come from a JAX ``make_policy("graph", ...).init`` (3 message
passing layers of 128, Flax's defaults) through ``params_from_jax``; the
same numpy node features and adjacency go through both networks.
Logits and value must agree within atol = rtol = 1e-5 at float32 and
within 2e-2 at bfloat16 (the band of ``tests/test_torch_models.py``:
Flax and torch round bf16 at other points inside a layer). The policy
heads are scaled by 100 there too, so the logits are O(1) and the bf16
band can tell them from zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlgpuschedule_tpu.env.obs import build_adjacency as jbuild_adjacency
from rlgpuschedule_tpu.models import make_policy as jmake_policy
from rlgpuschedule_tpu_torch.env.obs import GRAPH_FEATURES, build_adjacency
from rlgpuschedule_tpu_torch.models import (GNNActorCritic, make_policy,
                                            params_from_jax)

# the tensors here are tiny: more threads only contend with the other
# test workers
torch.set_num_threads(1)

B, N, K = 6, 4, 3
HEADS = ("slot_policy", "preempt_policy", "noop_policy")


def _layout(P, R):
    V = N + K + R
    return V, K * P + R + 1


def _inputs(P, R, seed=0):
    V, A = _layout(P, R)
    rng = np.random.default_rng(seed)
    obs = rng.random((B, V, GRAPH_FEATURES), dtype=np.float32)
    mask = rng.random((B, A)) < 0.6
    mask[:, -1] = True
    return obs, mask


def _pair(P, R, dtype, policy_gain=1.0, rack=2):
    V, A = _layout(P, R)
    adj = build_adjacency(N, K, rack, R)
    obs, mask = _inputs(P, R)
    jnet = jmake_policy("graph", A, n_cluster_nodes=N, queue_len=K,
                        n_placements=P, preempt_len=R,
                        dtype=getattr(jnp, dtype))
    params = jax.device_get(jax.jit(jnet.init)(
        jax.random.PRNGKey(1), obs, jnp.asarray(adj), mask))
    for h in HEADS:
        if h in params["params"]:
            head = params["params"][h]
            head["kernel"] = np.asarray(head["kernel"]) * np.float32(
                policy_gain)
    tnet = make_policy("graph", A, (V, GRAPH_FEATURES),
                       dtype=getattr(torch, dtype), device="cpu",
                       adjacency=adj, n_cluster_nodes=N, queue_len=K,
                       n_placements=P, preempt_len=R)
    tnet.load_state_dict(params_from_jax(params))
    return jnet, params, tnet, adj, obs, mask


LAYOUTS = [(2, 0), (2, 4), (1, 4)]
CASES = [(p, r, d, t) for p, r in LAYOUTS
         for d, t in (("float32", 1e-5), ("bfloat16", 2e-2))]


@pytest.mark.parametrize("P,R,dtype,tol", CASES,
                         ids=[f"P{p}-R{r}-{d}" for p, r, d, _ in CASES])
def test_gnn_logits_and_value_match_jax(P, R, dtype, tol):
    jnet, params, tnet, adj, obs, mask = _pair(P, R, dtype,
                                               policy_gain=100.0)
    jl, jv = jax.jit(jnet.apply)(params, obs, jnp.asarray(adj), mask)
    with torch.no_grad():
        tl, tv = tnet(torch.from_numpy(obs), torch.from_numpy(mask))
    assert tl.dtype == torch.float32 and tv.dtype == torch.float32
    jl = np.asarray(jl)
    assert np.abs(jl[mask]).max() > 10 * tol, "logits too small to compare"
    np.testing.assert_allclose(tl.numpy(), jl, rtol=tol, atol=tol)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=tol,
                               atol=tol)
    top2 = np.sort(jl, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol * (1 + np.abs(top2[:, 1]))
    assert clear.any()
    np.testing.assert_array_equal(tl.numpy().argmax(-1)[clear],
                                  jl.argmax(-1)[clear])
    np.testing.assert_array_equal(tl.numpy()[~mask], np.float32(-1e9))


def test_params_from_jax_names_the_three_layer_gnn_tree():
    """Flax names the compact submodules in call order: per layer the
    message ``Dense_{2i}`` (with a bias), the self ``Dense_{2i+1}``
    (without) and ``LayerNorm_i``; then the four heads. The adjacency is
    a buffer on the port's side and never enters ``state_dict``."""
    _, params, tnet, _, _, _ = _pair(2, 4, "float32")
    sd = params_from_jax(params)
    enc = [f"encoder.Dense_{d}.{w}" for d in range(6)
           for w in (("weight", "bias") if d % 2 == 0 else ("weight",))]
    enc += [f"encoder.LayerNorm_{i}.{w}" for i in range(3)
            for w in ("weight", "bias")]
    heads = [f"{h}.{w}" for h in HEADS + ("value",)
             for w in ("weight", "bias")]
    assert set(sd) == set(tnet.state_dict()) == set(enc + heads)
    assert "a_norm" not in tnet.state_dict()
    adj = build_adjacency(N, K, 2, 4).astype(np.float32)
    a_norm = adj / np.maximum(adj.sum(-1, keepdims=True), 1.0)
    assert torch.equal(tnet.a_norm, torch.from_numpy(a_norm))
    flax = params["params"]
    np.testing.assert_array_equal(sd["slot_policy.weight"].numpy(),
                                  np.asarray(flax["slot_policy"]["kernel"]).T)
    assert tuple(sd["slot_policy.weight"].shape) == (2, 128)
    assert tuple(sd["encoder.Dense_0.weight"].shape) == (128, GRAPH_FEATURES)
    for k, v in tnet.state_dict().items():
        assert v.shape == sd[k].shape and v.dtype == sd[k].dtype, k


def test_gnn_slot_logits_follow_slot_features():
    """Slot logits come from each slot's own node: permuting the queue
    slots' features permutes their logits (``tests/test_models.py``)."""
    P, R = 2, 0
    _, _, tnet, _, obs, _ = _pair(P, R, "float32", policy_gain=100.0,
                                  rack=None)
    perm = np.array([2, 0, 1])
    obs_p = obs.copy()
    obs_p[:, N:N + K] = obs[:, N + perm]
    mask = torch.ones(B, K * P + 1, dtype=torch.bool)
    with torch.no_grad():
        a, _ = tnet(torch.from_numpy(obs), mask)
        b, _ = tnet(torch.from_numpy(obs_p), mask)
    sa = a[:, :K * P].reshape(B, K, P)
    sb = b[:, :K * P].reshape(B, K, P)
    torch.testing.assert_close(sb, sa[:, perm], rtol=1e-5, atol=1e-5)


def test_gnn_init_draws_from_the_flax_distributions():
    V, A = _layout(2, 4)
    kw = dict(adjacency=jbuild_adjacency(N, K, 2, 4), n_cluster_nodes=N,
              queue_len=K, n_placements=2, preempt_len=4, device="cpu",
              seed=3)
    net = make_policy("graph", A, (V, GRAPH_FEATURES), **kw)
    again = make_policy("graph", A, (V, GRAPH_FEATURES), **kw)
    assert isinstance(net, GNNActorCritic)
    for (name, p), q in zip(net.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(p, q), f"{name} is not a function of the seed"
    for name, p in net.state_dict().items():
        if name.endswith("bias"):
            assert not p.any(), name
        elif "LayerNorm" in name:
            assert (p == 1).all(), name
    for head, gain in ((net.slot_policy, 0.01), (net.preempt_policy, 0.01),
                       (net.noop_policy, 0.01), (net.value, 1.0)):
        w = head.weight.detach().double()
        np.testing.assert_allclose((w @ w.T).numpy(),
                                   gain ** 2 * np.eye(w.shape[0]),
                                   atol=1e-6 * max(gain ** 2, 1e-4))
    with pytest.raises(ValueError, match="adjacency"):
        make_policy("graph", A, (V, GRAPH_FEATURES), device="cpu")
    with pytest.raises(ValueError, match="does not give"):
        make_policy("graph", A + 1, (V, GRAPH_FEATURES),
                    **dict(kw, seed=0))
