"""CUDA wrapper for the fused PQ code gather + ADC kernel.

Replaces the Pallas kernel ``gather_adc_masked``
(``src/repro/kernels/gather_adc.py``). The source is ``csrc/gather_adc.cu``;
its header says what bounds the kernel on the H100 (bytes: per scored id
one random M-byte code row, its visited word and M entries of the query's
lookup table) and how its design answers that (one thread per (query, id),
the M LUT entries read through the cache instead of staging whole LUTs,
8-byte code loads, the mask epilogue fused). Scores are summed m = 0..M-1 as
``kernels.ref.gather_adc_ref`` sums them, so the two agree to the last bit.
This wrapper takes CUDA tensors only; ``kernels.ops`` sends CPU tensors to
the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_INT_MAX = 2**31 - 1

LAUNCHES = {"gather_adc_masked": 0}

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("gather_adc").gather_adc_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(ids, codes, luts, visited):
    tensors = {"ids": ids, "codes": codes, "luts": luts, "visited": visited}
    dev = ids.device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, dt in (("ids", torch.int32), ("codes", torch.uint8),
                     ("luts", torch.float32), ("visited", torch.int32)):
        if tensors[name].dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {tensors[name].dtype}")
    if ids.dim() != 2 or codes.dim() != 2 or luts.dim() != 3 or visited.dim() != 2:
        raise ValueError("ids (Q, R), codes (n, M), luts (Q, M, K) and visited "
                         "(Q, W) must be 2-, 2-, 3- and 2-D")
    Q, R = ids.shape
    n, M = codes.shape
    K = luts.shape[2]
    W = visited.shape[1]
    if luts.shape[:2] != (Q, M) or visited.shape[0] != Q:
        raise ValueError(f"shape mismatch: ids {tuple(ids.shape)}, codes "
                         f"{tuple(codes.shape)}, luts {tuple(luts.shape)}, visited "
                         f"{tuple(visited.shape)}")
    if n < 1 or M < 1 or W < 1 or not 1 <= K <= 256:
        raise ValueError(f"unsupported shape: n={n}, M={M}, W={W} (each >= 1), "
                         f"K={K} (1..256: the codes are uint8)")
    if max(Q, R, n, M * K, W) > _INT_MAX:
        raise ValueError("dimension exceeds the kernel's int32 indexing")
    ref.check_codes_fit(codes, K)   # the kernel indexes luts[m * K + code] unchecked
    return Q, R, n, M, K, W


def gather_adc_masked(ids: torch.Tensor, codes: torch.Tensor, luts: torch.Tensor,
                      visited: torch.Tensor):
    """ids (Q, R) i32 into codes (n, M) u8, per-query LUTs (Q, M, K) f32,
    visited (Q, ceil(n/32)) i32 -> (ADC dists (Q, R) f32, masked ids (Q, R)
    i32); padding and visited ids come back as (+inf, -1). Codes and LUTs
    must come from one PQ table: a code >= K raises."""
    Q, R, n, M, K, W = _check(ids, codes, luts, visited)
    out_d = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    out_i = torch.empty(ids.shape, dtype=torch.int32, device=ids.device)
    vec8 = M % 8 == 0 and codes.data_ptr() % 8 == 0
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        status = _entry()(
            ids.data_ptr(), codes.data_ptr(), luts.data_ptr(), visited.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), Q, R, n, M, K, W, int(vec8), stream,
        )
    _build.check(status, "gather_adc_f32")
    LAUNCHES["gather_adc_masked"] += 1
    return out_d, out_i
