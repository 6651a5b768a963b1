"""The attention backward of the port on the CPU against live calls into
repro: ``kernels.ref.flash_attention_bwd_ref`` (the backward kernel's plain
version) and autograd through the CPU ``ops.flash_attention`` (its
autograd Function, whose CPU route runs the plain forward, saves its
log-sum-exp and runs the plain backward from it) against ``jax.vjp`` of the
reference's dense oracle (``repro.kernels.ref.flash_attention_ref``) and of
the chunked ``repro.models.layers.attention_full`` the reference trains
through: causal and windowed masks, G = 1 / 4 / 8, dh 16 / 64 / 128 / 256,
dh 192 with dhv 128, ragged S and a given scale. The plain log-sum-exp
(``flash_attention_ref(..., return_lse=True)``, the forward kernel's
unit: log2) against ``jax.nn.logsumexp`` of the reference's own masked
scores (``_gqa_scores``) times log2(e), within 1e-5 (fp32 sums in another
order). The wrappers refuse an lse of the wrong shape or dtype on the host.

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
from repro_torch.kernels import flash_attention as kfa
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



def _reference_lse(q, k, causal, window, scale):
    """jax.nn.logsumexp over the reference's own masked scores
    (``_gqa_scores``, -inf where ``attention_full`` masks), times log2(e):
    (B, Hq, S)."""
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    s = JL._gqa_scores(q.reshape(B, S, Hkv, Hq // Hkv, dh) * scale, k)
    pos = np.arange(S)
    mask = np.ones((S, S), bool)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    s = jax.numpy.where(mask[None, None, None], s, -jax.numpy.inf)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, Hq, S) * np.log2(np.e)


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c[1:8])))
def test_plain_lse_matches_jax_logsumexp_of_the_reference_scores(case):
    Bq, Sq, Hq, Hkv, dh, dhv, causal, window, scale = case
    q, k, v, _ = _attn_inputs(Bq, Sq, Hq, Hkv, dh, dhv, seed=2)
    want = _reference_lse(q, k, causal, window, scale)
    out, lse = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal, window,
                                       scale, return_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (Bq, Hq, Sq)
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out.numpy(), ref.flash_attention_ref(
        *map(torch.from_numpy, (q, k, v)), causal, window, scale).numpy())


def _chunk(S):
    """attention_full's kv_chunk: the largest divisor of S below S, or S."""
    return max([c for c in range(2, S) if S % c == 0], default=S)


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c[1:8])))
def test_autograd_from_the_saved_lse_matches_jax_vjp_of_attention_full(case, monkeypatch):
    """The autograd Function on CPU tensors saves the forward's lse and its
    backward runs the plain backward from it (the data flow of the card's
    bf16 route): its (dq, dk, dv) against jax.vjp of attention_full."""
    Bq, Sq, Hq, Hkv, dh, dhv, causal, window, scale = case
    q, k, v, g = _attn_inputs(Bq, Sq, Hq, Hkv, dh, dhv, seed=3)
    _, vjp = jax.vjp(lambda q, k, v: JL.attention_full(q, k, v, causal=causal, window=window,
                                                       kv_chunk=_chunk(Sq),
                                                       softmax_scale=scale), q, k, v)
    want = vjp(g)
    seen = []
    plain_bwd = ref.flash_attention_bwd_ref

    def recorded(*args):
        seen.append(args[-1])
        return plain_bwd(*args)
    monkeypatch.setattr(ref, "flash_attention_bwd_ref", recorded)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ops.flash_attention(*leaves, causal=causal, window=window,
                        softmax_scale=scale).backward(torch.from_numpy(g))
    _check_grads([x.grad for x in leaves], want, "autograd from the saved lse")
    assert len(seen) == 1 and seen[0] is not None
    np.testing.assert_allclose(seen[0].numpy(), _reference_lse(q, k, causal, window, scale),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("bad", ["shape", "dtype", "missing"])
def test_the_wrappers_refuse_a_wrong_lse_before_any_launch(bad):
    B, S, Hq, Hkv, dh = 1, 24, 4, 2, 32
    rng = np.random.default_rng(4)
    q, k, v, out, dout = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                          .to(torch.bfloat16)
                          for shape in ((B, S, Hq, dh), (B, S, Hkv, dh), (B, S, Hkv, dh),
                                        (B, S, Hq, dh), (B, S, Hq, dh)))
    lse = {"shape": torch.zeros((B * Hq, S)), "dtype": torch.zeros((B, Hq, S),
                                                                    dtype=torch.bfloat16),
           "missing": None}[bad]
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="lse"):
        kfa.flash_attention_bwd(q, k, v, out, dout, lse=lse)
    if lse is not None:
        with pytest.raises(ValueError, match="lse"):
            ops.flash_attention_bwd(q, k, v, out, dout, lse=lse)
    assert ops.launch_counts() == before and not kfa._bwd_tc_fns
