"""Transformer building blocks of the LMs (dense GQA, sliding-window, the
hybrid local:global pattern, GShard MoE and DeepSeek's MLA), mirroring
``repro/models/layers.py`` with its dtype rules.

Weights keep the reference's (in, out) layout, so ``x @ w`` needs no
transpose and carried weights load as they are. Full-sequence attention
(prefill) goes through ``kernels.ops.flash_attention``: the hand-written
kernel on the card, its dense plain version on the CPU. The reference runs
a chunked online-softmax scan there; the two compute the same function
(``tests/test_kernels.py`` holds them interchangeable). Single-token decode
attention stays plain PyTorch, as it is an einsum outside any Pallas kernel
in the reference.

``mla_forward`` is multi-head latent attention (DeepSeek-V2/V3). Prefill
decompresses K and V from the latent and runs full attention at dh = dn +
dr, dhv = dv (192 / 128 for DeepSeek-V3) through the flash kernel; decode
absorbs ``w_uk`` into the query and ``w_uv`` into the output and scores the
cached latent directly, plain PyTorch as in the reference.

``moe_forward`` is the reference's GShard dispatch with static capacity
(one group per batch row), computed by index: each kept (token, k)
assignment is copied into its expert's slot and each token gathers its K
expert outputs, where the reference multiplies by dense (B, S, E, C) one-hot
tensors (1.34 GB each in fp32 at Qwen3's 8 x 2048). The kept set and the
gates are the same; the three expert products are ``torch.bmm``, as the
reference's are einsums outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from ..distributed import sharding
from ..kernels import ops


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
    dhv) in q's dtype, through the flash-attention kernel. A true
    ``global_override`` (a bool or a 0-d tensor; the hybrid pattern's global
    layer) turns the window off, as the reference ORs it into the mask."""
    if global_override is not None and bool(global_override):
        window = None

    def flash(q, k, v):
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   softmax_scale=softmax_scale)

    if sharding.is_dtensor(q):
        return sharding.attention(flash, q, k, v)
    return flash(q, k, v)


def write_rows(cache: torch.Tensor, slots: torch.Tensor, values: torch.Tensor) -> None:
    """``cache[b, slots[b]] = values[b]`` for every row b, in place (on each
    rank's shard where the cache is a DTensor)."""
    if sharding.is_dtensor(cache):
        sharding.write_rows(cache, slots, values)
        return
    cache.index_put_((torch.arange(cache.shape[0], device=cache.device), slots), values)


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
    q = sharding.split_last(x @ p["wq"], n_heads, d_head)
    k = sharding.split_last(x @ p["wk"], n_kv, d_head)
    v = sharding.split_last(x @ p["wv"], n_kv, d_head)
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


# -- MLA (DeepSeek-V2/V3) ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """The reference's fields and defaults (DeepSeek-V3's widths)."""
    n_heads: int = 128
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


def mla_forward(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: MLAConfig, *,
                rope_theta: float, cache=None, cache_len=None):
    """x (B, S, D) -> (out (B, S, D), (kv_c, k_rope)). The query goes
    through its low-rank path (``w_dq``, ``q_norm``, ``w_uq``) into a
    no-RoPE part (dn) and a RoPE part (dr); the keys and values come from
    the latent ``kv_c = rms_norm(x @ w_dkv)`` (r) and one shared RoPE key
    head ``x @ w_kr`` (dr). Scores are scaled by (dn + dr) ** -0.5.

    Without ``cache`` (prefill): K and V are decompressed (``w_uk``,
    ``w_uv``), the RoPE key broadcast to every head, and full causal
    attention runs at dh = dn + dr, dhv = dv; returns this sequence's
    latent and RoPE key. With ``cache`` = (kv_c (B, Smax, r), k_rope (B,
    Smax, dr)) and ``cache_len`` (B,) (decode, S = 1): the token's latent
    and RoPE key are written into the caches in place at ``cache_len``, and
    the query scores the cached latent with ``w_uk`` absorbed (``q_abs``, in
    x's dtype), in fp32, over the first ``cache_len + 1`` slots; the fp32
    latent output is cast to x's dtype before ``w_uv``, as the reference
    casts it."""
    B, S, _ = x.shape
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    scale = (dn + dr) ** -0.5
    q_lat = rms_norm(x @ p["w_dq"], p["q_norm"])
    q = sharding.split_last(q_lat @ p["w_uq"], H, dn + dr)
    q_nope, q_rope = q[..., :dn], rope(q[..., dn:], positions, rope_theta)
    kv_c = rms_norm(x @ p["w_dkv"], p["kv_norm"])                        # (B, S, r)
    k_rope = rope((x @ p["w_kr"])[:, :, None, :], positions, rope_theta)[:, :, 0]
    if cache is None:
        k_nope = sharding.split_last(kv_c @ p["w_uk"], H, dn)
        v = sharding.split_last(kv_c @ p["w_uv"], H, dv)
        # TMA cannot read a stride-0 head axis: the shared key is materialised
        k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, dr)], dim=-1)
        o = attention_full(torch.cat([q_nope, q_rope], dim=-1), k, v, causal=True,
                           softmax_scale=scale)
        out = o.reshape(B, S, H * dv) @ p["wo"]
        return out, (kv_c, k_rope)
    if S != 1:
        raise ValueError(f"the absorbed decode takes one token a row, got S={S}")
    kvc, krc = cache
    write_rows(kvc, cache_len, kv_c[:, 0])
    write_rows(krc, cache_len, k_rope[:, 0])
    q_abs = torch.einsum("bshd,rhd->bshr", q_nope, p["w_uk"].reshape(-1, H, dn))
    s_nope = torch.einsum("bshr,bkr->bhsk", q_abs.float(), kvc.float())
    s_rope = torch.einsum("bshd,bkd->bhsk", q_rope.float(), krc.float())
    s = (s_nope + s_rope)[:, :, 0, :] * scale                           # (B, H, Smax)
    mask = torch.arange(kvc.shape[1], device=x.device)[None, :] < (cache_len + 1)[:, None]
    attn = torch.softmax(s.masked_fill(~mask[:, None], float("-inf")), dim=-1)
    o_lat = torch.einsum("bhk,bkr->bhr", attn, kvc.float())             # (B, H, r)
    o = torch.einsum("bhr,rhd->bhd", o_lat.to(x.dtype), p["w_uv"].reshape(-1, H, dv))
    return o.reshape(B, 1, H * dv) @ p["wo"], (kvc, krc)


# -- MoE (GShard dispatch with static capacity) ----------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's fields and defaults; the ``*_spec`` fields (GSPMD
    shardings) are kept and unused."""
    n_experts: int = 64
    top_k: int = 8
    d_ff: int = 2048
    n_shared: int = 0          # shared experts (DeepSeek)
    shared_d_ff: int = 2048
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    expert_in_spec: Any = None
    dispatch_dtype: Any = None     # combine's gates and expert outputs in this dtype
    dispatch_spec: Any = None


class MoERoute(NamedTuple):
    """Where ``moe_route`` sends each (token, k) assignment of x (B, S, D)."""

    probs: torch.Tensor      # (B, S, E) fp32 router softmax
    gates: torch.Tensor      # (B, S, K) fp32, renormalised; 0 where dropped
    experts: torch.Tensor    # (B, S, K) int64, best first (ties: lowest index)
    slots: torch.Tensor      # (B, S, K) int64 rank in its expert's queue
    keep: torch.Tensor       # (B, S, K) bool: slots < capacity
    capacity: int            # C slots per expert per batch row
    load: torch.Tensor       # (E,) fp32 share of all assignments (kept or not)


def moe_route(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig) -> MoERoute:
    """The router in fp32, softmax, top-K (a stable descending sort: equal
    probabilities lowest index first, as ``lax.top_k``), gates renormalised
    with a 1e-9 floor; C = max(int(capacity_factor * S * K / E), 1). An
    assignment's slot is its rank among its expert's assignments of the same
    batch row in token-major, then k order (the reference's cumsum over the
    flattened S * K axis): a stable sort of the row's S * K expert ids puts
    each expert's assignments together in that order, and the rank is the
    position in the sorted row less the expert's first position. Slots past
    C are dropped and their gates zeroed."""
    B, S, _ = x.shape
    E = cfg.n_experts
    K = min(cfg.top_k, E)
    probs = torch.softmax(x.float() @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[..., :K], idx[..., :K]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    C = max(int(cfg.capacity_factor * S * K / E), 1)
    flat = experts.reshape(B, S * K)
    counts = torch.zeros((B, E), dtype=torch.long, device=x.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    ids, order = torch.sort(flat, dim=1, stable=True)
    first = (counts.cumsum(1) - counts).gather(1, ids)
    rank = torch.arange(S * K, device=x.device) - first
    slots = torch.empty_like(flat).scatter_(1, order, rank).reshape(B, S, K)
    keep = slots < C
    load = counts.sum(0).float() / (B * S * K)
    return MoERoute(probs, gates * keep, experts, slots, keep, C, load)


def moe_dispatch(x: torch.Tensor, route: MoERoute, e0: int = 0,
                 e1: int | None = None) -> torch.Tensor:
    """x (B, S, D) -> the slot buffer (E, B, C, D) in x's dtype: slot (e, b,
    c) holds the token routed there, or zeros. The buffer is built as row
    indices (E, B, C + 1) into x's rows with a zero row after each batch
    row's S tokens (dropped assignments all written to slot C), then one
    ``index_select`` of whole rows; only experts [e0, e1) are gathered
    (all by default; a rank's own experts under a mesh)."""
    B, S, D = x.shape
    E, C = route.probs.shape[-1], route.capacity
    b = torch.arange(B, device=x.device)[:, None, None]
    tok = (b * (S + 1) + S).expand(B, E, C + 1).transpose(0, 1).contiguous()
    s = torch.arange(S, device=x.device)[None, :, None] + b * (S + 1)
    tok[route.experts, b, torch.where(route.keep, route.slots, C)] = s.expand_as(route.experts)
    padded = torch.cat([x, x.new_zeros((B, 1, D))], dim=1).reshape(B * (S + 1), D)
    tok = tok[e0:e1, :, :C]
    return padded.index_select(0, tok.reshape(-1)).reshape(tok.shape[0], B, C, D)


def moe_experts(p: dict, xin: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on their slots: xin (E, B, C, D) -> (E, B, C, D),
    three batched products over E in xin's dtype."""
    E, B, C, D = xin.shape
    h = xin.reshape(E, B * C, D)
    a = F.silu(torch.bmm(h, p["w_gate"])) * torch.bmm(h, p["w_up"])
    return torch.bmm(a, p["w_down"]).reshape(E, B, C, D)


def moe_combine(eout: torch.Tensor, route: MoERoute, dtype: torch.dtype,
                dispatch_dtype=None) -> torch.Tensor:
    """Each token's K expert outputs (E, B, C, D) times its gates, summed in
    fp32 -> (B, S, D) in ``dtype``. Where ``dispatch_dtype`` is set, the
    gates are rounded to it first and the sum to its promotion with the
    outputs' dtype, as the reference's einsum of the two. A dropped
    assignment reads slot 0 with gate 0."""
    E, B, C, D = eout.shape
    b = torch.arange(B, device=eout.device)[:, None, None]
    rows = (route.experts * B + b) * C + torch.where(route.keep, route.slots, 0)
    got = eout.reshape(E * B * C, D).index_select(0, rows.reshape(-1))
    gates = route.gates if dispatch_dtype is None else route.gates.to(dispatch_dtype)
    Bs, S, K = gates.shape
    out = torch.bmm(gates.float().reshape(Bs * S, 1, K),
                    got.float().reshape(Bs * S, K, D)).reshape(Bs, S, D)
    if dispatch_dtype is not None:
        out = out.to(torch.promote_types(dispatch_dtype, eout.dtype))
    return out.to(dtype)


def moe_combine_range(eout: torch.Tensor, route: MoERoute, e0: int, e1: int,
                      dispatch_dtype=None) -> torch.Tensor:
    """:func:`moe_combine` of the outputs of experts [e0, e1) only (eout
    (e1 - e0, B, C, D)): an assignment to another expert has gate 0."""
    if e0 or e1 != route.probs.shape[-1]:
        inside = (route.experts >= e0) & (route.experts < e1)
        route = route._replace(gates=route.gates * inside, keep=route.keep & inside,
                               experts=(route.experts - e0).clamp(0, e1 - e0 - 1))
    return moe_combine(eout, route, eout.dtype, dispatch_dtype)


def moe_forward(p: dict, x: torch.Tensor, cfg: MoEConfig):
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux fp32 scalar): route,
    dispatch, the experts, combine, plus the shared experts where
    ``n_shared``; aux is the Switch load-balance loss ``router_aux_weight *
    E * sum(load * mean prob)``. Where x is a DTensor the routed part runs
    on each rank's batch rows and experts (``distributed.sharding.moe``)."""
    if sharding.is_dtensor(x):
        out, load, prob = sharding.moe(
            lambda router, xl: moe_route(router, xl, cfg),
            lambda w, xl, route, e0, e1: moe_experts(w, moe_dispatch(xl, route, e0, e1)),
            lambda eout, route, e0, e1: moe_combine_range(eout, route, e0, e1,
                                                          cfg.dispatch_dtype),
            p, x)
    else:
        route = moe_route(p["router"], x, cfg)
        eout = moe_experts(p, moe_dispatch(x, route))
        out = moe_combine(eout, route, x.dtype, cfg.dispatch_dtype)
        load, prob = route.load, route.probs.mean((0, 1))
    if cfg.n_shared:
        sp = p["shared"]
        out = out + swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])
    aux = cfg.router_aux_weight * cfg.n_experts * (load * prob).sum()
    return out, aux
