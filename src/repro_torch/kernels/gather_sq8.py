"""CUDA wrappers for the fused uint8 gather + dequantized distance kernels.

Replace the Pallas kernel ``gather_sq8_masked``
(``src/repro/kernels/gather_sq8.py``). The source is ``csrc/gather_sq8.cu``;
its header says what bounds the kernels on the H100 (bytes: one random
d-byte row per scored id; at the beam's hop, the latency of dependent
loads) and how their design answers that. :func:`gather_sq8_masked`, the
beam's sq8 hop, runs the hop kernel: one 8-lane group per (query, slot)
pair over the whole grid, padding slots out at once, the visited word, the
code row and the query, scale and mn rows loaded together, one FMA to
dequantize, the generic kernel's bits. :func:`gather_sq8_masked_generic`
runs the generic kernel (a warp per id, query, scale and mn staged in
shared memory), the hop kernel's yardstick; no path of the port calls it.
These wrappers take CUDA tensors only; ``kernels.ops`` sends CPU tensors
to ``kernels.ref.gather_sq8_masked_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .gather_distance import HOP_PAIRS, MAX_R_TILES, METRIC_CODES

MAX_D = 4096           # the generic kernel stages query, scale and mn in 48 KB
_INT_MAX = 2**31 - 1

# kernel launches by entry point (read and reset by chip_smoke.py)
LAUNCHES = {"gather_sq8_masked": 0, "gather_sq8_masked_generic": 0}

_fn = None
_hop_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("gather_sq8").gather_sq8_f32
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _hop_entry():
    global _hop_fn
    if _hop_fn is None:
        fn = _build.load("gather_sq8").gather_sq8_hop_f32
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _hop_fn = fn
    return _hop_fn


def hop_grid(Q: int, R: int, n: int, d: int, W: int) -> int:
    """Blocks of the hop kernel for Q x R pairs, HOP_PAIRS a block. Raises
    ValueError where the grid or the kernel's int32 indexing cannot take
    the shape."""
    if min(Q, R, d) < 0 or n < 1 or W < 1:
        raise ValueError(f"unsupported shape: Q={Q} R={R} n={n} (>= 1) d={d} W={W} (>= 1)")
    blocks = -(-Q * R // HOP_PAIRS)
    if max(Q, R, n, d, W) > _INT_MAX or blocks > _INT_MAX:
        raise ValueError(f"shape exceeds the hop kernel's grid or int32 indexing: Q={Q} "
                         f"R={R} n={n} d={d} W={W} ({blocks} blocks)")
    return blocks


def _check(queries, ids, codes, scale, mn, visited, metric):
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}; one of {sorted(METRIC_CODES)}")
    tensors = {"queries": queries, "ids": ids, "codes": codes, "scale": scale,
               "mn": mn, "visited": visited}
    dev = queries.device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, dt in (("queries", torch.float32), ("ids", torch.int32),
                     ("codes", torch.uint8), ("scale", torch.float32),
                     ("mn", torch.float32), ("visited", torch.int32)):
        if tensors[name].dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {tensors[name].dtype}")
    if queries.dim() != 2 or ids.dim() != 2 or codes.dim() != 2 or visited.dim() != 2:
        raise ValueError("queries (Q, d), ids (Q, R), codes (n, d) and visited "
                         "(Q, W) must be 2-D")
    Q, d = queries.shape
    n = codes.shape[0]
    R = ids.shape[1]
    W = visited.shape[1]
    if (ids.shape[0] != Q or codes.shape[1] != d or scale.shape != (d,)
            or mn.shape != (d,) or visited.shape[0] != Q):
        raise ValueError(f"shape mismatch: queries {tuple(queries.shape)}, ids "
                         f"{tuple(ids.shape)}, codes {tuple(codes.shape)}, scale "
                         f"{tuple(scale.shape)}, mn {tuple(mn.shape)}, visited "
                         f"{tuple(visited.shape)}")
    return Q, R, n, d, W


def _outputs(queries, ids):
    return (torch.empty(ids.shape, dtype=torch.float32, device=queries.device),
            torch.empty(ids.shape, dtype=torch.int32, device=queries.device))


def gather_sq8_masked(queries: torch.Tensor, ids: torch.Tensor,
                      codes: torch.Tensor, scale: torch.Tensor, mn: torch.Tensor,
                      visited: torch.Tensor, metric: str = "l2"):
    """queries (Q, d) f32, ids (Q, R) i32 into codes (n, d) u8 with scale/mn
    (d,) f32, visited (Q, ceil(n/32)) i32 -> (dists (Q, R) f32, masked ids
    (Q, R) i32); padding and visited ids come back as (+inf, -1). Runs the
    hop kernel."""
    Q, R, n, d, W = _check(queries, ids, codes, scale, mn, visited, metric)
    hop_grid(Q, R, n, d, W)
    out_d, out_i = _outputs(queries, ids)
    if Q * R == 0:
        return out_d, out_i
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        status = _hop_entry()(
            queries.data_ptr(), ids.data_ptr(), codes.data_ptr(), scale.data_ptr(),
            mn.data_ptr(), visited.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            Q, R, n, d, W, METRIC_CODES[metric], stream,
        )
    _build.check(status, "gather_sq8_hop_f32")
    LAUNCHES["gather_sq8_masked"] += 1
    return out_d, out_i


def gather_sq8_masked_generic(queries: torch.Tensor, ids: torch.Tensor,
                              codes: torch.Tensor, scale: torch.Tensor,
                              mn: torch.Tensor, visited: torch.Tensor,
                              metric: str = "l2"):
    """:func:`gather_sq8_masked` on the generic kernel (one warp per id, 4
    ids a warp in series): the hop kernel's yardstick, bit for bit and in
    time. No path of the port calls it."""
    Q, R, n, d, W = _check(queries, ids, codes, scale, mn, visited, metric)
    if n < 1 or W < 1 or d > MAX_D or -(-R // 32) > MAX_R_TILES:
        raise ValueError(f"unsupported shape: n={n} (>= 1), W={W} (>= 1), d={d} "
                         f"(<= {MAX_D}), R={R} (<= {32 * MAX_R_TILES})")
    if max(Q, R, n, d, W) > _INT_MAX:
        raise ValueError("dimension exceeds the kernel's int32 indexing")
    out_d, out_i = _outputs(queries, ids)
    vec4 = d % 4 == 0 and codes.data_ptr() % 4 == 0
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        status = _entry()(
            queries.data_ptr(), ids.data_ptr(), codes.data_ptr(), scale.data_ptr(),
            mn.data_ptr(), visited.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            Q, R, n, d, W, METRIC_CODES[metric], int(vec4), stream,
        )
    _build.check(status, "gather_sq8_f32")
    LAUNCHES["gather_sq8_masked_generic"] += 1
    return out_d, out_i
