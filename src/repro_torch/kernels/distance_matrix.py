"""CUDA wrapper for the batched distance-matrix kernels.

Replaces the Pallas kernel ``distance_matrix``
(``src/repro/kernels/distance_matrix.py``). The source is
``csrc/distance_matrix.cu``; its header says what bounds it on the H100
(fp32 flops for ground truth, bytes for the GD batch) and how its design
answers that. Two routes, chosen here by :func:`matrix_route`: where q, n
<= 32 (the GD batch) the small route, one warp a matrix over a persistent
grid, each matrix's rows staged once by cp.async (once for both sides when
x is y), double-buffered per warp, half the dot products where x is y
(they are symmetric bit for bit), the outputs out as float4 stores
(:func:`small_plan` sizes its stages); else a 128 x 128 tile a block, 8 x 8
fp32 FMA sums a thread, float4 staging overlapped with the product, k-row
fragments double-buffered, norms out of the product loop, batch folded
into gridDim.x. Never TF32: the reference is fp32.
:func:`distance_matrix_tile32` runs the first 32 x 32 tile, the small
route's yardstick (the same bits); no path of the port calls it. These
wrappers take CUDA tensors only; ``kernels.ops`` sends CPU tensors to
``kernels.ref.distance_matrix_ref``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .gather_distance import METRIC_CODES

SMALL_TILE = 32        # both sides at most this wide -> the small route
LARGE_TILE = 128       # every other matrix: the 128 x 128 tile
H100_SMS = 132
SMALL_WARPS = 8        # warps (matrices in flight) a block of the small route
SMALL_BLOCKS_PER_SM = 2
# a warp's shared memory on the small route: 8 warps x 2 blocks fit an SM
# (2 x 8 x 14,336 B + 2 KB reserved <= 228 KB)
SMALL_WARP_FLOATS = 3584
MAX_KC = 64            # columns a stage
NORM_SLOTS = 64
_INT_MAX = 2**31 - 1
_GRID_Y_MAX = 65535

# kernel launches by entry point (read and reset by chip_smoke.py):
# distance_matrix counts the 128 tile, distance_matrix_small the small route
LAUNCHES = {"distance_matrix": 0, "distance_matrix_small": 0, "distance_matrix_tile32": 0}

_fn = None
_small_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("distance_matrix").distance_matrix_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _small_entry():
    global _small_fn
    if _small_fn is None:
        fn = _build.load("distance_matrix").distance_matrix_small_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _small_fn = fn
    return _small_fn


def matrix_route(B: int, q: int, n: int, d: int,
                 sms: int = H100_SMS) -> tuple[int, tuple[int, int]]:
    """(route, (grid x, grid y)) of the kernel launch for B matrices of
    (q, d) x (n, d) on a card of ``sms`` SMs. Where both sides are at most
    32 wide (the GD batch), the small route (SMALL_TILE): a persistent grid
    of SMALL_BLOCKS_PER_SM blocks an SM, or fewer where B needs fewer, its
    warps walking over the matrices. Else the 128 x 128 tile: grid x holds
    B x the n-tiles, grid y the q-tiles. Raises ValueError on a shape the
    grid or the kernel's int32 indexing cannot take."""
    if min(B, q, n, d) < 0:
        raise ValueError(f"negative shape: B={B} q={q} n={n} d={d}")
    if q <= SMALL_TILE and n <= SMALL_TILE:
        tile = SMALL_TILE
        grid = (max(1, min(-(-B // SMALL_WARPS), SMALL_BLOCKS_PER_SM * sms)), 1)
        over = B > _INT_MAX or d > _INT_MAX
    else:
        tile = LARGE_TILE
        grid = (B * -(-n // tile), -(-q // tile))
        over = grid[0] > _INT_MAX or grid[1] > _GRID_Y_MAX or max(q, n, d) > _INT_MAX
    if over:
        raise ValueError(f"shape exceeds the launch grid: B={B} q={q} n={n} d={d} "
                         f"(tile {tile}, grid {grid})")
    return tile, grid


def _stride(kc: int) -> int:
    """A staged row's floats: kc rounded so that stride / 4 is odd, which
    puts the float4 reads of neighbouring rows in different bank groups."""
    return kc if (kc // 4) % 2 else kc + 4


class SmallPlan(NamedTuple):
    kc: int               # columns a stage, a multiple of 4
    stride: int           # floats a staged row
    smem_bytes: int       # dynamic shared memory a block


def small_plan(q: int, n: int, d: int, same: bool) -> SmallPlan:
    """The small route's stages for (q, d) x (n, d), 1 <= q, n <= 32 (x is
    y when ``same``): the widest chunk of columns, at most MAX_KC, whose two
    stage buffers, the q*n outputs and the norms fit a warp's
    SMALL_WARP_FLOATS."""
    if not (1 <= q <= SMALL_TILE and 1 <= n <= SMALL_TILE) or d < 0 or (same and q != n):
        raise ValueError(f"not a small-route shape: q={q} n={n} d={d} same={same}")
    rows = q if same else q + n
    room = SMALL_WARP_FLOATS - 4 * -(-q * n // 4) - NORM_SLOTS
    kc = max(4, min(MAX_KC, 4 * -(-d // 4)))
    while kc > 4 and 2 * rows * _stride(kc) > room:
        kc -= 4
    warp_floats = 2 * rows * _stride(kc) + 4 * -(-q * n // 4) + NORM_SLOTS
    return SmallPlan(kc, _stride(kc), SMALL_WARPS * warp_floats * 4)


def _operands(x: torch.Tensor, y: torch.Tensor, metric: str):
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
    xb = x if x.dim() == 3 else x.unsqueeze(0)
    yb = y if y.dim() == 3 else y.unsqueeze(0)
    if yb.shape[0] != xb.shape[0] or yb.shape[2] != xb.shape[2]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, y {tuple(y.shape)}")
    return xb, yb


def distance_matrix(x: torch.Tensor, y: torch.Tensor,
                    metric: str = "l2") -> torch.Tensor:
    """(q, d) x (n, d) -> (q, n), or (B, q, d) x (B, n, d) -> (B, q, n),
    float32 CUDA tensors."""
    xb, yb = _operands(x, y, metric)
    B, q, d = xb.shape
    n = yb.shape[1]
    tile, grid = matrix_route(B, q, n, d,
                              torch.cuda.get_device_properties(x.device).multi_processor_count)
    out = torch.empty((B, q, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out if x.dim() == 3 else out[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if tile == SMALL_TILE:
            same = xb.data_ptr() == yb.data_ptr() and xb.shape == yb.shape
            plan = small_plan(q, n, d, same)
            status = _small_entry()(xb.data_ptr(), yb.data_ptr(), out.data_ptr(), B, q, n,
                                    d, METRIC_CODES[metric], int(same), plan.kc,
                                    plan.stride, grid[0], stream)
            _build.check(status, "distance_matrix_small_f32")
            LAUNCHES["distance_matrix_small"] += 1
        else:
            status = _entry()(xb.data_ptr(), yb.data_ptr(), out.data_ptr(),
                              B, q, n, d, METRIC_CODES[metric], tile, stream)
            _build.check(status, "distance_matrix_f32")
            LAUNCHES["distance_matrix"] += 1
    return out if x.dim() == 3 else out[0]


def distance_matrix_tile32(x: torch.Tensor, y: torch.Tensor,
                           metric: str = "l2") -> torch.Tensor:
    """:func:`distance_matrix` for q, n <= 32 on the first 32 x 32 tile (one
    256-thread block a matrix): the small route's yardstick, bit for bit
    and in time. No path of the port calls it."""
    xb, yb = _operands(x, y, metric)
    B, q, d = xb.shape
    n = yb.shape[1]
    if matrix_route(B, q, n, d)[0] != SMALL_TILE:
        raise ValueError(f"the 32 x 32 tile takes q, n <= 32, got q={q} n={n}")
    if B * -(-n // SMALL_TILE) > _INT_MAX:
        raise ValueError(f"shape exceeds the launch grid: B={B}")
    out = torch.empty((B, q, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out if x.dim() == 3 else out[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = _entry()(xb.data_ptr(), yb.data_ptr(), out.data_ptr(),
                          B, q, n, d, METRIC_CODES[metric], SMALL_TILE, stream)
    _build.check(status, "distance_matrix_f32")
    LAUNCHES["distance_matrix_tile32"] += 1
    return out if x.dim() == 3 else out[0]
