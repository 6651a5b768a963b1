"""Device dispatch for the ported kernels.

A CPU tensor goes to the plain version in ``kernels.ref``; a CUDA tensor goes
to the hand-written kernel, which raises on anything it does not take.
Nothing falls back from the card to a plain version. ``flash_attention`` is
differentiable: where autograd records, it runs as an autograd Function whose
backward is the backward kernel on the card and its plain version on the CPU
(the reference's Pallas kernel has no VJP; its models train through plain
attention, whose gradient this computes). The reference's
one-hot gather branch is not carried over: it exists only for the TPU's
matrix unit and is bit-identical to the plain gather.
"""
from __future__ import annotations

import torch

from . import distance_matrix as _dm
from . import flash_attention as _fa
from . import gather_adc as _ga
from . import gather_distance as _gd
from . import gather_distance_pool as _gp
from . import gather_sq8 as _gs
from . import pq_adc as _pa
from . import ref

_COUNTERS = (_gd.LAUNCHES, _gp.LAUNCHES, _dm.LAUNCHES, _gs.LAUNCHES, _ga.LAUNCHES,
             _pa.LAUNCHES, _fa.LAUNCHES)


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}; use 'cuda' or 'cpu'")


def distance_matrix(x, y, metric: str = "l2"):
    """(q, d) x (n, d) -> (q, n), or batched (B, q, d) x (B, n, d)."""
    if _on_cpu(x):
        return ref.distance_matrix_ref(x, y, metric)
    return _dm.distance_matrix(x, y, metric)


def gather_distance(queries, ids, base, metric: str = "l2"):
    """(Q, d) x ids (Q, R) into base (n, d) -> (Q, R); ids < 0 -> +inf."""
    if _on_cpu(queries):
        return ref.gather_distance_ref(queries, ids, base, metric)
    return _gd.gather_distance(queries, ids, base, metric)


def gather_distance_pool(base, pool, metric: str = "l2", chunk: int = 1024):
    """base (n, d), pool (n, C) ids -> (n, C): each row's distances to its
    own candidates (the NN-Descent scoring pass); ids < 0 -> +inf. Only the
    plain version reads ``chunk`` (rows a step, to bound its memory)."""
    if _on_cpu(base):
        return ref.gather_distance_pool_ref(base, pool, metric, chunk)
    return _gp.gather_distance_pool(base, pool, metric)


def gather_distance_masked(queries, ids, base, visited, metric: str = "l2"):
    """Fused gather + distance + visited/validity mask -> (dists, masked
    ids): padding (< 0) and bitmap-visited ids come back as (+inf, -1)."""
    if _on_cpu(queries):
        return ref.gather_distance_masked_ref(queries, ids, base, visited, metric)
    return _gd.gather_distance_masked(queries, ids, base, visited, metric)


def gather_sq8_masked(queries, ids, codes, scale, mn, visited, metric: str = "l2"):
    """Fused uint8 gather + dequantized distance + visited/validity mask ->
    (dists, masked ids): ids (Q, R) scored against the (n, d) uint8 table
    dequantized per dimension as ``codes * scale + mn``."""
    if _on_cpu(queries):
        return ref.gather_sq8_masked_ref(queries, ids, codes, scale, mn, visited,
                                         metric)
    return _gs.gather_sq8_masked(queries, ids, codes, scale, mn, visited, metric)


def gather_adc_masked(ids, codes, luts, visited):
    """Fused PQ code gather + ADC + visited/validity mask -> (dists, masked
    ids) against per-query (Q, M, K) LUTs; the LUT carries the metric."""
    if _on_cpu(ids):
        return ref.gather_adc_masked_ref(ids, codes, luts, visited)
    return _ga.gather_adc_masked(ids, codes, luts, visited)


def pq_adc(codes, luts):
    """codes (n, M) against a LUT (M, K) -> (n,), or LUTs (Q, M, K) ->
    (Q, n) ADC scores."""
    if _on_cpu(codes):
        return ref.pq_adc_ref(codes, luts)
    return _pa.pq_adc(codes, luts)


# The flash-attention kernels on ``meta`` tensors (the dry run: shapes, no
# data): one op each, whose outputs have the kernel's shapes and dtypes, so a
# dispatch-mode counter sees the kernel as one call (``launch/dryrun.py``
# costs it) instead of the plain version's ops. Nothing runs; no launch is
# counted.


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                             window: int | None, softmax_scale: float | None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    raise ValueError("flash_attention_fwd_meta takes meta tensors only")


@flash_attention_fwd_meta.register_fake
def _(q, k, v, causal, window, softmax_scale):
    B, S, H, _ = q.shape
    return (q.new_empty((B, S, H, v.shape[-1])),
            q.new_empty((B, H, S), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, dout: torch.Tensor, causal: bool,
                             window: int | None, softmax_scale: float | None
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    raise ValueError("flash_attention_bwd_meta takes meta tensors only")


@flash_attention_bwd_meta.register_fake
def _(q, k, v, out, dout, causal, window, softmax_scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_forward(q, k, v, causal, window, softmax_scale, return_lse=False):
    if q.device.type == "meta":
        out, lse = flash_attention_fwd_meta(q, k, v, causal, window, softmax_scale)
        return (out, lse) if return_lse else out
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v, causal, window, softmax_scale, return_lse)
    return _fa.flash_attention(q, k, v, causal, window, softmax_scale, return_lse)


def flash_attention_bwd(q, k, v, out, dout, causal: bool = True,
                        window: int | None = None, softmax_scale: float | None = None,
                        lse=None):
    """The gradient of ``flash_attention`` at (q, k, v) given its output
    ``out``, its cotangent ``dout`` and, where the forward saved it, its
    log-sum-exp ``lse`` (fp32 (B, Hq, S), log2 unit) -> (dq, dk, dv) in the
    inputs' dtypes. The card's bf16 route needs ``lse``; the plain version
    recomputes it where none is given."""
    if q.device.type == "meta":
        return flash_attention_bwd_meta(q, k, v, out, dout, causal, window, softmax_scale)
    if lse is not None:
        _fa.check_lse(lse, q)
    if _on_cpu(q):
        return ref.flash_attention_bwd_ref(q, k, v, out, dout, causal, window,
                                           softmax_scale, lse)
    return _fa.flash_attention_bwd(q, k, v, out, dout, causal, window, softmax_scale, lse)


def _saves_lse(q) -> bool:
    """Whether the forward saves its log-sum-exp for the backward: on the
    CPU's plain path and the card's bf16 route (the fp32 card route
    recomputes it)."""
    return q.device.type in ("cpu", "meta") or q.dtype == torch.bfloat16


class _FlashAttention(torch.autograd.Function):
    """The forward's one launch (or plain call), saving q, k, v, the output
    and (:func:`_saves_lse`) the log-sum-exp; the backward is
    ``flash_attention_bwd`` on the same device."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softmax_scale):
        if _saves_lse(q):
            out, lse = _flash_forward(q, k, v, causal, window, softmax_scale, True)
        else:
            out, lse = _flash_forward(q, k, v, causal, window, softmax_scale), None
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, softmax_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, *ctx.mask, lse)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int | None = None,
                    softmax_scale: float | None = None):
    """GQA attention q (B, S, Hq, dh), k/v (B, S, Hkv, d) -> (B, S, Hq, dhv)
    in q's dtype: causal and/or windowed mask, fp32 scores and softmax.
    Where autograd records and an input requires grad it is differentiable
    (``_FlashAttention``); otherwise (``inference_mode``, ``no_grad``,
    frozen inputs) it is the forward's single launch and nothing is saved."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, softmax_scale)
    return _flash_forward(q, k, v, causal, window, softmax_scale)


def launch_counts() -> dict[str, int]:
    """Kernel launches per entry point since the last reset."""
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0
