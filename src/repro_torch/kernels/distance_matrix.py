"""CUDA wrapper for the batched distance-matrix kernel.

Replaces the Pallas kernel ``distance_matrix``
(``src/repro/kernels/distance_matrix.py``). The source is
``csrc/distance_matrix.cu``; its header says what bounds it on the H100
(fp32 flops for ground truth, gathered-row bytes for the GD batch) and how
its design answers that (a 128 x 128 tile a block, 8 x 8 fp32 FMA sums a
thread, float4 staging overlapped with the product, k-row fragments
double-buffered, norms out of the product loop; a 32 x 32 tile for the GD
batch; batch folded into gridDim.x). Never TF32: the reference is fp32. The route is chosen here,
by :func:`matrix_route`. This wrapper takes CUDA tensors only;
``kernels.ops`` sends CPU tensors to ``kernels.ref.distance_matrix_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .gather_distance import METRIC_CODES

SMALL_TILE = 32        # both sides at most this wide -> the 32 x 32 tile
LARGE_TILE = 128       # every other matrix: the 128 x 128 tile
_INT_MAX = 2**31 - 1
_GRID_Y_MAX = 65535

LAUNCHES = {"distance_matrix": 0}

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("distance_matrix").distance_matrix_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def matrix_route(B: int, q: int, n: int, d: int) -> tuple[int, tuple[int, int]]:
    """(tile, (grid x, grid y)) of the kernel launch for B matrices of
    (q, d) x (n, d): the 32 x 32 tile where both sides are at most 32 wide
    (the GD batch), else the 128 x 128 tile; grid x holds B x the n-tiles,
    grid y the q-tiles. Raises ValueError on a shape the grid or the
    kernel's int32 indexing cannot take."""
    if min(B, q, n, d) < 0:
        raise ValueError(f"negative shape: B={B} q={q} n={n} d={d}")
    tile = SMALL_TILE if q <= SMALL_TILE and n <= SMALL_TILE else LARGE_TILE
    grid = (B * -(-n // tile), -(-q // tile))
    if grid[0] > _INT_MAX or grid[1] > _GRID_Y_MAX or max(q, n, d) > _INT_MAX:
        raise ValueError(f"shape exceeds the launch grid: B={B} q={q} n={n} d={d} "
                         f"(tile {tile}, grid {grid})")
    return tile, grid


def distance_matrix(x: torch.Tensor, y: torch.Tensor,
                    metric: str = "l2") -> torch.Tensor:
    """(q, d) x (n, d) -> (q, n), or (B, q, d) x (B, n, d) -> (B, q, n),
    float32 CUDA tensors."""
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}; one of {sorted(METRIC_CODES)}")
    for name, t in (("x", x), ("y", y)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != y.dim() or x.dim() not in (2, 3):
        raise ValueError("x and y must both be (q, d)/(n, d) or (B, q, d)/(B, n, d)")
    batched = x.dim() == 3
    xb = x if batched else x.unsqueeze(0)
    yb = y if batched else y.unsqueeze(0)
    B, q, d = xb.shape
    if yb.shape[0] != B or yb.shape[2] != d:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, y {tuple(y.shape)}")
    n = yb.shape[1]
    tile, _ = matrix_route(B, q, n, d)
    out = torch.empty((B, q, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out if batched else out[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = _entry()(xb.data_ptr(), yb.data_ptr(), out.data_ptr(),
                          B, q, n, d, METRIC_CODES[metric], tile, stream)
    _build.check(status, "distance_matrix_f32")
    LAUNCHES["distance_matrix"] += 1
    return out if batched else out[0]
