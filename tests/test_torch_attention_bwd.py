"""The attention backward of the port on the CPU against live calls into
repro: ``kernels.ref.flash_attention_bwd_ref`` (the backward kernel's plain
version) and autograd through the CPU ``ops.flash_attention`` (its
autograd Function, whose CPU route runs the plain forward and backward)
against ``jax.vjp`` of the reference's dense oracle
(``repro.kernels.ref.flash_attention_ref``) and of the chunked
``repro.models.layers.attention_full`` the reference trains through
(``kv_chunk`` < S): causal and windowed masks, G = 1 / 4 / 8, dh 16 / 64 /
128 / 256, dh 192 with dhv 128, ragged S and a given scale.

Tolerance: each gradient within 1e-5 of its own max-abs (fp32; the two sum
in another order, and a dq or dk element sums terms that cancel). The
kernel itself is held to this plain version on the card
(``chip_smoke.py`` phase 2, ``tests/test_torch_cuda.py``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _close_by_max(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs error {err:.3g} > {rel} x {scale:.3g}"


# (B, S, Hq, Hkv, dh, dhv, causal, window, softmax_scale)
ATTN_CASES = [
    (2, 37, 4, 4, 16, 16, True, None, None),        # G = 1, ragged S
    (1, 70, 8, 2, 64, 64, True, None, None),        # G = 4
    (1, 45, 8, 1, 64, 64, True, 9, None),           # G = 8, windowed
    (1, 33, 4, 1, 128, 128, True, 16, 0.2),         # a given scale
    (1, 20, 2, 2, 256, 256, True, None, None),      # dh 256
    (1, 29, 4, 4, 192, 128, True, None, 192 ** -0.5 * 1.3),  # MLA's 192 / 128
    (1, 24, 4, 2, 32, 32, False, 5, None),          # window without causal
    (1, 19, 4, 2, 32, 32, False, None, None),       # full
]


def _attn_inputs(Bq, Sq, Hq, Hkv, dh, dhv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bq, Sq, Hq, dh)).astype(np.float32),
            rng.standard_normal((Bq, Sq, Hkv, dh)).astype(np.float32),
            rng.standard_normal((Bq, Sq, Hkv, dhv)).astype(np.float32),
            rng.standard_normal((Bq, Sq, Hq, dhv)).astype(np.float32))


def _check_grads(got, want, what):
    for name, a, b in zip("qkv", got, want):
        _close_by_max(a.detach().numpy(), np.asarray(b), 1e-5, f"{what} d{name}")


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c[1:8])))
def test_attention_backward_matches_jax_vjp_of_the_dense_oracle(case):
    Bq, Sq, Hq, Hkv, dh, dhv, causal, window, scale = case
    q, k, v, g = _attn_inputs(Bq, Sq, Hq, Hkv, dh, dhv)
    out, vjp = jax.vjp(lambda q, k, v: j_ref.flash_attention_ref(q, k, v, causal, window,
                                                                 scale), q, k, v)
    want = vjp(g)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    tout = ref.flash_attention_ref(tq, tk, tv, causal, window, scale)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), rtol=2e-5, atol=2e-5)
    _check_grads(ref.flash_attention_bwd_ref(tq, tk, tv, tout, tg, causal, window, scale),
                 want, "flash_attention_bwd_ref")
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    ops.flash_attention(*leaves, causal=causal, window=window,
                        softmax_scale=scale).backward(tg)
    _check_grads([x.grad for x in leaves], want, "autograd through ops.flash_attention")


@pytest.mark.parametrize("case", [(2, 48, 4, 4, 16, 16, 16, None), (1, 64, 8, 2, 64, 64, 16, 12),
                                  (1, 32, 8, 1, 256, 256, 8, None),
                                  (1, 36, 4, 4, 192, 128, 12, None)],
                         ids=lambda c: "-".join(map(str, c[1:8])))
def test_attention_backward_matches_jax_vjp_of_the_chunked_attention(case):
    """The reference trains through ``attention_full`` (a kv_chunk scan);
    the port's gradient is that function's."""
    Bq, Sq, Hq, Hkv, dh, dhv, chunk, window = case
    q, k, v, g = _attn_inputs(Bq, Sq, Hq, Hkv, dh, dhv, seed=1)
    scale = (dh ** -0.5) if dh != 192 else 0.07
    _, vjp = jax.vjp(lambda q, k, v: JL.attention_full(q, k, v, causal=True, window=window,
                                                       kv_chunk=chunk, softmax_scale=scale),
                     q, k, v)
    want = vjp(g)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ops.flash_attention(*leaves, causal=True, window=window,
                        softmax_scale=scale).backward(torch.from_numpy(g))
    _check_grads([x.grad for x in leaves], want, "autograd through ops.flash_attention")

