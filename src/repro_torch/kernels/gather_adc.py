"""CUDA wrappers for the fused PQ code gather + ADC kernels.

Replace the Pallas kernel ``gather_adc_masked``
(``src/repro/kernels/gather_adc.py``). The source is ``csrc/gather_adc.cu``;
its header says what bounds the kernels on the H100 (bytes: per scored id
one random M-byte code row, its visited word and M entries of the query's
lookup table; at the beam's hop, the launch and the chain of dependent
loads) and how their design answers that. :func:`gather_adc_masked`, the
beam's pq hop, runs the hop kernel: one thread per (query, slot) pair,
padding slots out at once, the visited word loaded with the code row and
its bit applied at the store, three loads deep. :func:`gather_adc_masked_generic`
runs the generic kernel (the mask guarding the code loads, four deep), the
hop kernel's yardstick; no path of the port calls it. Both sum m = 0..M-1
from 0.0 as ``kernels.ref.gather_adc_ref`` sums, so all three agree to the
last bit. These wrappers take CUDA tensors only; ``kernels.ops`` sends CPU
tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_INT_MAX = 2**31 - 1
THREADS = 256   # a block of either kernel: one thread a (query, slot) pair

# kernel launches by entry point (read and reset by chip_smoke.py)
LAUNCHES = {"gather_adc_masked": 0, "gather_adc_masked_generic": 0}

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("gather_adc").gather_adc_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def hop_grid(Q: int, R: int, n: int, M: int, K: int, W: int) -> int:
    """Blocks of either kernel for Q x R pairs, THREADS a block. Raises
    ValueError where the grid or the kernels' int32 indexing cannot take
    the shape."""
    if min(Q, R) < 0 or min(n, M, W) < 1 or not 1 <= K <= 256:
        raise ValueError(f"unsupported shape: Q={Q} R={R} n={n} M={M} W={W} (each >= 1), "
                         f"K={K} (1..256: the codes are uint8)")
    blocks = -(-Q * R // THREADS)
    if max(Q, R, n, M * K, W) > _INT_MAX or blocks > _INT_MAX:
        raise ValueError(f"shape exceeds the hop kernel's grid or int32 indexing: Q={Q} "
                         f"R={R} n={n} M={M} K={K} W={W} ({blocks} blocks)")
    return blocks


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
    hop_grid(Q, R, n, M, K, W)
    ref.check_codes_fit(codes, K)   # the kernels index luts[m * K + code] unchecked
    return Q, R, n, M, K, W


def _launch(ids, codes, luts, visited, hop: bool):
    Q, R, n, M, K, W = _check(ids, codes, luts, visited)
    out_d = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    out_i = torch.empty(ids.shape, dtype=torch.int32, device=ids.device)
    if Q * R == 0:
        return out_d, out_i
    vec8 = M % 8 == 0 and codes.data_ptr() % 8 == 0
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        status = _entry()(
            ids.data_ptr(), codes.data_ptr(), luts.data_ptr(), visited.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), Q, R, n, M, K, W, int(vec8), int(hop), stream,
        )
    _build.check(status, "gather_adc_f32")
    LAUNCHES["gather_adc_masked" if hop else "gather_adc_masked_generic"] += 1
    return out_d, out_i


def gather_adc_masked(ids: torch.Tensor, codes: torch.Tensor, luts: torch.Tensor,
                      visited: torch.Tensor):
    """ids (Q, R) i32 into codes (n, M) u8, per-query LUTs (Q, M, K) f32,
    visited (Q, ceil(n/32)) i32 -> (ADC dists (Q, R) f32, masked ids (Q, R)
    i32); padding and visited ids come back as (+inf, -1). Codes and LUTs
    must come from one PQ table: a code >= K raises. Runs the hop kernel."""
    return _launch(ids, codes, luts, visited, hop=True)


def gather_adc_masked_generic(ids: torch.Tensor, codes: torch.Tensor, luts: torch.Tensor,
                              visited: torch.Tensor):
    """:func:`gather_adc_masked` on the generic kernel (the mask guarding the
    code loads): the hop kernel's yardstick, bit for bit and in time. No
    path of the port calls it."""
    return _launch(ids, codes, luts, visited, hop=False)
