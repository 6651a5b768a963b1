"""Transformer building blocks of the dense GQA LMs, mirroring
``repro/models/layers.py`` with its dtype rules.

Weights keep the reference's (in, out) layout, so ``x @ w`` needs no
transpose and carried weights load as they are. Full-sequence attention
(prefill) goes through ``kernels.ops.flash_attention``: the hand-written
kernel on the card, its dense plain version on the CPU. The reference runs
a chunked online-softmax scan there; the two compute the same function
(``tests/test_kernels.py`` holds them interchangeable). Single-token decode
attention stays plain PyTorch, as it is an einsum outside any Pallas kernel
in the reference. MLA, MoE and the hybrid local:global flag are not ported
yet (ROADMAP queue A item 14).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops

NOT_PORTED = "not ported yet (ROADMAP queue A item 14)"


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """fp32 variance and rsqrt; the product cast back to x's dtype, then
    times ``scale``."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, dh), positions (..., S) -> rotated x (halves, not
    interleaved); angles in fp32, the result cast back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int | None = None,
                   softmax_scale: float | None = None,
                   global_override=None) -> torch.Tensor:
    """q (B, S, Hq, dh), k (B, S, Hkv, dh), v (B, S, Hkv, dhv) -> (B, S, Hq,
    dhv) in q's dtype, through the flash-attention kernel."""
    if global_override is not None:
        raise NotImplementedError(f"the hybrid local:global mask is {NOT_PORTED}")
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               softmax_scale=softmax_scale)


def gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B, Sq, Hkv, G, dh) x k (B, Skv, Hkv, dh) -> (B, Hkv, G, Sq, Skv)
    fp32 (the reference's ``preferred_element_type=float32``)."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length: torch.Tensor, *, window: int | None = None,
                     softmax_scale: float | None = None) -> torch.Tensor:
    """q (B, 1, Hq, dh) against caches (B, Smax, Hkv, d) whose first
    ``length`` (B,) slots are valid (the new token included)."""
    B, _, Hq, dh = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    qg = q.reshape(B, 1, Hkv, Hq // Hkv, dh) * scale
    s = gqa_scores(qg, k_cache)[..., 0, :]                       # (B, Hkv, G, Skv)
    pos = torch.arange(Smax, device=q.device)[None, :]
    mask = pos < length[:, None]
    if window is not None:
        mask &= pos >= (length[:, None] - window)
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, Hq, v_cache.shape[-1]).to(q.dtype)


def gqa_forward(p: dict, x: torch.Tensor, positions: torch.Tensor, *, n_heads: int,
                n_kv: int, d_head: int, rope_theta: float,
                window: int | None = None, cache=None, cache_len=None,
                global_override=None):
    """x (B, S, D) -> (out (B, S, D), (k, v)). Without ``cache``: full
    causal attention over the sequence. With ``cache`` = (k, v) (B, Smax,
    Hkv, dh) and ``cache_len`` (B,) the length before these tokens: the new
    k/v are written into the caches in place at ``cache_len`` and attention
    runs over the cache."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, d_head)
    k = (x @ p["wk"]).reshape(B, S, n_kv, d_head)
    v = (x @ p["wv"]).reshape(B, S, n_kv, d_head)
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    if cache is None:
        o = attention_full(q, k, v, causal=True, window=window,
                           global_override=global_override)
        new_cache = (k, v)
    else:
        kc, vc = cache
        slots = cache_len[:, None] + torch.arange(S, device=x.device)   # (B, S)
        rows = torch.arange(B, device=x.device)[:, None].expand(B, S)
        kc.index_put_((rows, slots), k)
        vc.index_put_((rows, slots), v)
        o = attention_decode(q, kc, vc, cache_len + S, window=window)
        new_cache = (kc, vc)
    out = o.reshape(B, S, n_heads * d_head) @ p["wo"]
    return out, new_cache
