"""CUDA wrapper for the dense PQ asymmetric-distance scan.

Replaces the Pallas kernel ``pq_adc`` (``src/repro/kernels/pq_adc.py``);
the reference's vmap over queries is the kernel's batch dimension. The
source is ``csrc/pq_adc.cu``; its header says what bounds the kernel on the
H100 (bytes: the (Q, n) f32 scores) and how its design answers that (the
LUTs of a few queries staged in shared memory, each code row read once for
all of them, coalesced score rows). Scores are summed m = 0..M-1 as
``kernels.ref.pq_adc_ref`` sums them, so the two agree to the last bit.
This wrapper takes CUDA tensors only; ``kernels.ops`` sends CPU tensors to
the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

QUERIES_PER_BLOCK = 8         # LUTs staged per block: 64 KB at M=8, K=256
SMEM_FLOATS = 232_448 // 4    # a block's shared memory on the H100
_INT_MAX = 2**31 - 1

LAUNCHES = {"pq_adc": 0}

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("pq_adc").pq_adc_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def pq_adc(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """codes (n, M) u8 against one LUT (M, K) f32 -> (n,) f32 ADC scores, or
    against a batch of LUTs (Q, M, K) -> (Q, n). Codes and LUTs must come
    from one PQ table: a code >= K raises."""
    for name, t, dt in (("codes", codes, torch.uint8), ("luts", luts, torch.float32)):
        if t.device.type != "cuda" or t.device != codes.device:
            raise ValueError(f"{name} must be a CUDA tensor on {codes.device}, "
                             f"got {t.device}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if codes.dim() != 2 or luts.dim() not in (2, 3):
        raise ValueError("codes must be (n, M) and luts (M, K) or (Q, M, K)")
    batched = luts.dim() == 3
    lb = luts if batched else luts.unsqueeze(0)
    Q, M, K = lb.shape
    n = codes.shape[0]
    if codes.shape[1] != M:
        raise ValueError(f"shape mismatch: codes {tuple(codes.shape)}, luts "
                         f"{tuple(luts.shape)}")
    if M < 1 or not 1 <= K <= 256 or M * K > SMEM_FLOATS:
        raise ValueError(f"unsupported LUT shape: M={M} (>= 1), K={K} (1..256: "
                         f"the codes are uint8), M*K <= {SMEM_FLOATS}")
    qb = max(1, min(QUERIES_PER_BLOCK, SMEM_FLOATS // (M * K)))
    if max(Q, n) > _INT_MAX or -(-Q // qb) > 65535:
        raise ValueError(f"shape exceeds the launch grid: Q={Q} n={n}")
    ref.check_codes_fit(codes, K)   # the kernel indexes the LUT by code unchecked
    out = torch.empty((Q, n), dtype=torch.float32, device=codes.device)
    vec8 = M % 8 == 0 and codes.data_ptr() % 8 == 0
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        status = _entry()(codes.data_ptr(), lb.data_ptr(), out.data_ptr(),
                          Q, n, M, K, qb, int(vec8), stream)
    _build.check(status, "pq_adc_f32")
    LAUNCHES["pq_adc"] += 1
    return out if batched else out[0]
