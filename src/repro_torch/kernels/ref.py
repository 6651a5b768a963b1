"""Plain PyTorch versions of the ported kernels.

Same formulas as ``repro/kernels/ref.py``: l2 in diff form for the gathers,
expanded and clamped for the matrix, rsqrt-clamped cos. The CPU path runs
these; on the card they are the oracle each CUDA kernel is held against.
They work on any device.
"""
from __future__ import annotations

import torch


def _rsqrt_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=1e-12))


def distance_matrix_ref(x: torch.Tensor, y: torch.Tensor,
                        metric: str = "l2") -> torch.Tensor:
    """(q, d) x (n, d) -> (q, n), or batched (B, q, d) x (B, n, d) ->
    (B, q, n); fp32 accumulation."""
    x = x.float()
    y = y.float()
    if metric == "cos":
        return 1.0 - _rsqrt_norm(x) @ _rsqrt_norm(y).transpose(-1, -2)
    cross = x @ y.transpose(-1, -2)
    if metric == "ip":
        return -cross
    if metric != "l2":
        raise ValueError(f"unknown metric {metric!r}")
    xx = (x * x).sum(-1).unsqueeze(-1)
    yy = (y * y).sum(-1).unsqueeze(-2)
    return torch.clamp(xx - 2.0 * cross + yy, min=0.0)


def _distances_from_rows(queries: torch.Tensor, ids: torch.Tensor,
                         rows: torch.Tensor, metric: str) -> torch.Tensor:
    """queries (Q, d) vs gathered rows (Q, R, d) -> (Q, R); ids < 0 -> +inf."""
    q = queries.float().unsqueeze(1)
    rows = rows.float()
    if metric == "ip":
        d = -(rows * q).sum(-1)
    elif metric == "cos":
        d = 1.0 - (_rsqrt_norm(rows) * _rsqrt_norm(q)).sum(-1)
    elif metric == "l2":
        diff = rows - q
        d = (diff * diff).sum(-1)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


def gather_distance_ref(queries: torch.Tensor, ids: torch.Tensor,
                        base: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """queries (Q, d), ids (Q, R) into base (n, d) -> (Q, R) distances.
    Padding ids (< 0) give +inf; ids past the base clamp to its last row,
    as an XLA gather does."""
    rows = base[ids.clamp(0, base.shape[0] - 1).long()]
    return _distances_from_rows(queries, ids, rows, metric)


def gather_distance_pool_ref(base: torch.Tensor, pool: torch.Tensor,
                             metric: str = "l2", chunk: int = 1024) -> torch.Tensor:
    """base (n, d), pool (n, C) ids -> (n, C): the distance from base[v] to
    base[pool[v, j]], i.e. :func:`gather_distance_ref` with the base's own
    rows as queries. Runs ``chunk`` rows at a time only to bound the memory
    of the gathered rows."""
    n, C = pool.shape
    out = torch.empty((n, C), dtype=torch.float32, device=pool.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        out[lo:hi] = gather_distance_ref(base[lo:hi], pool[lo:hi], base, metric)
    return out


def visited_mask_ref(ids: torch.Tensor, visited: torch.Tensor) -> torch.Tensor:
    """ids (Q, R) against a bit-packed (Q, ceil(n/32)) int32 visited bitmap
    -> ids with padding (< 0) and visited entries set to -1.

    The words are int32 holding the reference's uint32 bits. The shift is
    arithmetic, which still leaves the tested bit in bit 0."""
    W = visited.shape[1]
    safe = ids.clamp(min=0)
    words = visited.gather(1, torch.clamp(safe >> 5, max=W - 1).long())
    seen = ((words >> (safe & 31)) & 1) > 0
    return torch.where((ids >= 0) & ~seen, ids, torch.full_like(ids, -1))


def gather_distance_masked_ref(queries: torch.Tensor, ids: torch.Tensor,
                               base: torch.Tensor, visited: torch.Tensor,
                               metric: str = "l2"):
    """(dists, masked ids) where padding and visited entries come back as
    (+inf, -1)."""
    masked = visited_mask_ref(ids, visited)
    return gather_distance_ref(queries, masked, base, metric), masked


def check_codes_fit(codes: torch.Tensor, K: int) -> None:
    """Raise unless every code indexes a LUT of K entries, as it does when
    codes and LUTs come from one PQ table. uint8 codes always fit K = 256,
    so only a smaller K costs a pass over the codes (and a sync on the
    card)."""
    if K < 256 and codes.numel() and int(codes.max()) >= K:
        raise ValueError(f"codes reach {int(codes.max())}, past a LUT of K={K} "
                         f"entries: codes and LUTs must come from one PQ table")


def gather_adc_ref(ids: torch.Tensor, codes: torch.Tensor,
                   luts: torch.Tensor) -> torch.Tensor:
    """ids (Q, R) into a code table (n, M) uint8, per-query LUTs (Q, M, K)
    -> (Q, R) ADC scores ``sum_m luts[q, m, codes[ids[q, r], m]]``; ids < 0
    give +inf.

    The sum runs m = 0..M-1 from 0.0, one add at a time, as the CUDA kernel
    sums: the two agree to the last bit."""
    check_codes_fit(codes, luts.shape[-1])
    rows = codes[ids.clamp(0, codes.shape[0] - 1).long()].long()   # (Q, R, M)
    acc = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    for m in range(codes.shape[1]):
        acc = acc + luts[:, m, :].float().gather(1, rows[..., m])
    return torch.where(ids >= 0, acc, torch.full_like(acc, float("inf")))


def gather_adc_masked_ref(ids: torch.Tensor, codes: torch.Tensor,
                          luts: torch.Tensor, visited: torch.Tensor):
    """(ADC dists, masked ids) where padding and visited entries come back
    as (+inf, -1)."""
    masked = visited_mask_ref(ids, visited)
    return gather_adc_ref(masked, codes, luts), masked


def gather_sq8_ref(queries: torch.Tensor, ids: torch.Tensor, codes: torch.Tensor,
                   scale: torch.Tensor, mn: torch.Tensor,
                   metric: str = "l2") -> torch.Tensor:
    """ids (Q, R) into an (n, d) uint8 scalar-quantized table with
    per-dimension affine params scale/mn (d,) -> (Q, R) distances on the
    dequantized rows ``codes * scale + mn``; ids < 0 give +inf."""
    rows = codes[ids.clamp(0, codes.shape[0] - 1).long()].float()  # (Q, R, d)
    rows = rows * scale.float() + mn.float()
    return _distances_from_rows(queries, ids, rows, metric)


def gather_sq8_masked_ref(queries: torch.Tensor, ids: torch.Tensor,
                          codes: torch.Tensor, scale: torch.Tensor,
                          mn: torch.Tensor, visited: torch.Tensor,
                          metric: str = "l2"):
    """(dists, masked ids) where padding and visited entries come back as
    (+inf, -1)."""
    masked = visited_mask_ref(ids, visited)
    return gather_sq8_ref(queries, masked, codes, scale, mn, metric), masked


def pq_adc_ref(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """codes (n, M) uint8 against one LUT (M, K) -> (n,) ADC scores, or a
    batch of LUTs (Q, M, K) -> (Q, n): ``sum_m lut[m, codes[i, m]]``,
    summed m = 0..M-1 from 0.0 as the CUDA kernel sums."""
    check_codes_fit(codes, luts.shape[-1])
    idx = codes.long()
    acc = torch.zeros(luts.shape[:-2] + (codes.shape[0],), dtype=torch.float32,
                      device=codes.device)
    for m in range(codes.shape[1]):
        acc = acc + luts[..., m, :].float().index_select(-1, idx[:, m])
    return acc


LOG2E = 1.4426950408889634


def _attention_mask(S: int, causal: bool, window: int | None, device) -> torch.Tensor:
    """(S, S) bool, query rows by key columns: keys at or before the query
    (causal) and ``q_pos - k_pos < window``."""
    pos = torch.arange(S, device=device)
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int | None = None,
                        softmax_scale: float | None = None, return_lse: bool = False):
    """Dense GQA attention, the flash kernel's oracle: q (B, S, Hq, dh), k
    (B, S, Hkv, dh), v (B, S, Hkv, dhv) -> (B, S, Hq, dhv) in q's dtype.
    Query head h reads KV head h // (Hq // Hkv); scores ``(q * scale) . k``
    and the softmax in fp32; masked scores are -inf, and a row that sees no
    key (softmax NaN) comes out 0. Builds the (S, S) scores of every head.
    With ``return_lse`` -> (out, lse): lse fp32 (B, Hq, S), each row's
    log-sum-exp of its visible scores in the kernel's log2 unit (log2 of
    the sum of exp2(score * log2(e))), +inf for a row that sees no key (so
    exp2(x - lse) gives it P = 0, as in the kernel)."""
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    qg = q.reshape(B, S, Hkv, G, dh).float() * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    s = s.masked_fill(~_attention_mask(S, causal, window, q.device), float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = p.masked_fill(torch.isnan(p), 0.0)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = o.reshape(B, S, Hq, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1) * LOG2E                     # (B, Hkv, G, S)
    lse = lse.masked_fill(torch.isneginf(lse), float("inf"))
    return out, lse.reshape(B, Hq, S)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, dout: torch.Tensor, causal: bool = True,
                            window: int | None = None,
                            softmax_scale: float | None = None,
                            lse: torch.Tensor | None = None):
    """The gradient of ``flash_attention_ref``, dense in fp32, the backward
    kernels' oracle: (dq, dk, dv) in q's, k's and v's dtypes. P is the
    forward's masked softmax: from the forward's ``lse`` (fp32 (B, Hq, S),
    log2 unit) as the tensor-core kernels take it, P = exp2(score * log2(e)
    - lse), or recomputed where none is given; dP = dout . v; D =
    rowsum(dout * out) (the forward's output, as the kernels read it); dS =
    P (dP - D); dq = scale dS k, dk = scale dS^T q, dv = P^T dout, summed
    over the G query heads of each KV head. A row that sees no key has P =
    0, so its dq is 0 and it adds nothing to dk and dv, never NaN."""
    B, S, Hq, dh = q.shape
    Hkv, dhv = k.shape[2], v.shape[-1]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    qg = q.reshape(B, S, Hkv, G, dh).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg * scale, kf)
    mask = _attention_mask(S, causal, window, q.device)
    if lse is None:
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        p = p.masked_fill(torch.isnan(p), 0.0)
    else:
        p = torch.exp2(s * LOG2E - lse.reshape(B, Hkv, G, S, 1))
        p = p.masked_fill(~mask, 0.0)
    dog = dout.reshape(B, S, Hkv, G, dhv).float()
    delta = (dog * out.reshape(B, S, Hkv, G, dhv).float()).sum(-1)      # (B, S, Hkv, G)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return dq.reshape(B, S, Hq, dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
