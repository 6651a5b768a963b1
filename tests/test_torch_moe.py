"""The port's GShard MoE (``repro_torch.models.layers.moe_forward``) on the
CPU against live calls into ``repro.models.layers.moe_forward``.

The reference's own ``init_moe`` weights (seed 0) are carried across, the
inputs are numpy normals from a seed. The port dispatches by index where the
reference multiplies dense one-hot tensors, so the tests hold ``out`` (1e-5:
fp32 sums of the same K terms in another order), ``aux`` (1e-6) and the kept
set: the experts each token picks and which of its assignments fit the
capacity, recomputed here from the reference's steps (``lax.top_k``, the
cumsum over the flattened S * K axis). The Qwen3 smoke MoE (E=8, K=2) drops
assignments at capacity_factor 1.25 for S = 32 and 128 with these inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_moe_30b_a3b as j_qwen
from repro.models import layers as JL
from repro_torch.models import layers as L
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

D = 64
X_SEED = 2   # numpy seed of the inputs; drops 5 of 128 (S=32), 8 of 512 (S=128)


def _port_moe(jcfg: JL.MoEConfig, **over) -> L.MoEConfig:
    return L.MoEConfig(**{**dataclasses.asdict(jcfg), **over})


def _params(jcfg, dtype=jnp.float32):
    """(reference params, the same weights as torch tensors of their dtypes:
    the router fp32, the rest ``dtype``)."""
    jp = JL.init_moe(jax.random.PRNGKey(0), D, jcfg, dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(tdt),
                      jp)
    tp["router"] = torch.from_numpy(np.array(jp["router"]))
    return jp, tp


def _inputs(S, B=2):
    return np.random.default_rng(X_SEED).standard_normal((B, S, D), dtype=np.float32)


def _reference_kept(jp, x, jcfg):
    """(experts (B, S, K), keep (B, S, K)) by the reference's steps."""
    B, S, _ = x.shape
    E, K = jcfg.n_experts, min(jcfg.top_k, jcfg.n_experts)
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32) @ jp["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    C = max(int(jcfg.capacity_factor * S * K / E), 1)
    flat = jax.nn.one_hot(idx, E, dtype=jnp.float32).reshape(B, S * K, E)
    pos = jnp.einsum("bse,bse->bs", jnp.cumsum(flat, axis=1) - flat, flat).reshape(B, S, K)
    return np.asarray(idx), np.asarray(pos < C)


def _check(jp, tp, x, jcfg, cfg, out_tol, aux_tol=1e-6):
    want, want_aux = JL.moe_forward(jp, jnp.asarray(x), jcfg)
    got, got_aux = L.moe_forward(tp, torch.from_numpy(x).to(tp["w_up"].dtype), cfg)
    assert got.dtype == tp["w_up"].dtype and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
                               **out_tol)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=aux_tol, atol=aux_tol)
    route = L.moe_route(tp["router"], torch.from_numpy(x).to(tp["w_up"].dtype), cfg)
    experts, keep = _reference_kept(jp, x.astype(np.float32) if x.dtype != np.float32 else x,
                                    jcfg)
    np.testing.assert_array_equal(route.experts.numpy(), experts)
    np.testing.assert_array_equal(route.keep.numpy(), keep)
    assert not route.gates[~route.keep].any()
    return route


@pytest.mark.parametrize("S,drops", [(1, 0), (32, 5), (128, 8)])
def test_moe_forward_matches_reference(S, drops):
    """Qwen3 smoke MoE at capacity_factor 1.25, fp32: out, aux and the kept
    set; S = 1 is decode's group (C = 1, nothing drops)."""
    jcfg = j_qwen.SMOKE.moe
    jp, tp = _params(jcfg)
    route = _check(jp, tp, _inputs(S), jcfg, _port_moe(jcfg), dict(rtol=1e-5, atol=1e-5))
    assert route.capacity == max(int(1.25 * S * 2 / 8), 1)
    assert int((~route.keep).sum()) == drops


@pytest.mark.parametrize("S", [32, 128])
def test_moe_forward_shared_experts_and_capacity_2(S):
    """capacity_factor 2.0 with one shared expert (DeepSeek's layout)."""
    jcfg = dataclasses.replace(j_qwen.SMOKE.moe, capacity_factor=2.0, n_shared=1,
                               shared_d_ff=48)
    jp, tp = _params(jcfg)
    assert set(tp["shared"]) == {"w_gate", "w_up", "w_down"}
    _check(jp, tp, _inputs(S), jcfg, _port_moe(jcfg), dict(rtol=1e-5, atol=1e-5))


def test_moe_forward_bf16_matches_reference():
    """bf16 weights and inputs with the router in fp32: the same kept set,
    out within a few bf16 ulps of its scale (silu and the expert products
    round at other places in the two frameworks)."""
    jcfg = j_qwen.SMOKE.moe
    jp, tp = _params(jcfg, jnp.bfloat16)
    x = np.asarray(jnp.asarray(_inputs(128), jnp.bfloat16).astype(jnp.float32))
    want, _ = JL.moe_forward(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    scale = float(jnp.abs(want.astype(jnp.float32)).max())
    _check(jp, tp, x, jcfg, _port_moe(jcfg), dict(rtol=2 ** -6, atol=2 ** -6 * scale),
           aux_tol=1e-5)


def test_moe_dispatch_dtype_rounds_the_combine():
    """dispatch_dtype bf16 (the reference's D1 variant) on fp32 weights: the
    gates round to bf16 before the combine, as the reference's do."""
    jcfg = dataclasses.replace(j_qwen.SMOKE.moe, dispatch_dtype=jnp.bfloat16)
    jp, tp = _params(jcfg)
    x = _inputs(32)
    want, _ = JL.moe_forward(jp, jnp.asarray(x), jcfg)
    got, _ = L.moe_forward(tp, torch.from_numpy(x),
                           _port_moe(jcfg, dispatch_dtype=torch.bfloat16))
    exact, _ = L.moe_forward(tp, torch.from_numpy(x), _port_moe(jcfg, dispatch_dtype=None))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert not torch.equal(got, exact)


def test_moe_route_breaks_ties_lowest_index_first():
    """A zero router gives every expert the same probability: top-K takes
    experts 0 .. K-1, as lax.top_k does; slots count token-major."""
    cfg = L.MoEConfig(n_experts=8, top_k=2, d_ff=16, capacity_factor=1.0)
    x = torch.randn(1, 8, D)
    route = L.moe_route(torch.zeros(D, 8), x, cfg)
    _, idx = jax.lax.top_k(jnp.full((1, 8, 8), 0.125), 2)
    np.testing.assert_array_equal(route.experts.numpy(), np.asarray(idx))
    assert route.capacity == 2
    np.testing.assert_array_equal(route.slots[0, :, 0].numpy(), np.arange(8))
    assert route.keep[0, :2].all() and not route.keep[0, 2:].any()
    torch.testing.assert_close(route.gates[0, :2], torch.full((2, 2), 0.5))


def test_moe_dispatch_and_combine_by_index():
    """The slot buffer holds each kept token at (expert, row, slot) and zeros
    elsewhere; combine with identity experts gives x times the kept gates'
    sum."""
    jcfg = j_qwen.SMOKE.moe
    _, tp = _params(jcfg)
    cfg = _port_moe(jcfg)
    x = torch.from_numpy(_inputs(32))
    route = L.moe_route(tp["router"], x, cfg)
    xin = L.moe_dispatch(x, route)
    assert xin.shape == (8, 2, route.capacity, D)
    filled = 0
    for b in range(2):
        for s in range(32):
            for k in range(2):
                if route.keep[b, s, k]:
                    e, c = int(route.experts[b, s, k]), int(route.slots[b, s, k])
                    assert torch.equal(xin[e, b, c], x[b, s])
                    filled += 1
    assert int((xin.abs().sum(-1) > 0).sum()) == filled
    out = L.moe_combine(xin, route, x.dtype)
    torch.testing.assert_close(out, x * route.gates.sum(-1, keepdim=True))
