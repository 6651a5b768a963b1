"""CUDA wrappers for the fused gather + distance kernels.

Replace the Pallas kernels ``gather_distance`` and ``gather_distance_masked``
(``src/repro/kernels/gather_distance.py``). The source is
``csrc/gather_distance.cu``; its header says what bounds the kernels on
the H100 (bytes: one random 4*d-byte row per scored id; at the beam's hop,
the latency of dependent loads) and how their design answers that.
:func:`gather_distance` runs the pair kernel at every shape
(:func:`gather_route`): one 8-lane group per (query, slot) pair over the
whole grid. :func:`gather_distance_masked`, the beam's hop, runs the hop
kernel, the same layout with the visited word. Both have the generic
kernel's bits (one warp per id, lanes striding over d, a warp-shuffle
sum). :func:`gather_distance_generic` and
:func:`gather_distance_masked_generic` run the generic kernel, the
yardsticks; no path of the port calls them. These wrappers take CUDA
tensors only; ``kernels.ops`` sends CPU tensors to the plain versions in
``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

METRIC_CODES = {"l2": 0, "ip": 1, "cos": 2}
GENERIC_MAX_D = 12288  # the generic kernel stages the query row in 48 KB of shared memory
MAX_R_TILES = 65535    # the generic kernel's gridDim.y = ceil(R / 32)
HOP_PAIRS = 16         # (query, slot) pairs a pair or hop block: gridDim.x = ceil(Q R / 16)
_INT_MAX = 2**31 - 1

# kernel launches by entry point (read and reset by chip_smoke.py)
LAUNCHES = {"gather_distance": 0, "gather_distance_generic": 0,
            "gather_distance_masked": 0, "gather_distance_masked_generic": 0}

_fn = None
_hop_fn = None
_pair_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("gather_distance").gather_distance_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _hop_entry():
    global _hop_fn
    if _hop_fn is None:
        fn = _build.load("gather_distance").gather_distance_hop_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _hop_fn = fn
    return _hop_fn


def _pair_entry():
    global _pair_fn
    if _pair_fn is None:
        fn = _build.load("gather_distance").gather_distance_pairs_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _pair_fn = fn
    return _pair_fn


def pair_grid(Q: int, R: int, n: int, d: int) -> int:
    """Blocks of the pair (or hop) kernel for Q x R pairs, HOP_PAIRS a
    block. Raises ValueError where the grid or the kernel's int32 indexing
    cannot take the shape; d has no limit (the query row is read through
    L1, not staged)."""
    if min(Q, R, d) < 0 or n < 1:
        raise ValueError(f"unsupported shape: Q={Q} R={R} n={n} (>= 1) d={d}")
    blocks = -(-Q * R // HOP_PAIRS)
    if max(Q, R, n, d) > _INT_MAX or blocks > _INT_MAX:
        raise ValueError(f"dimension exceeds the kernel's int32 indexing: Q={Q} R={R} "
                         f"n={n} d={d} ({blocks} blocks)")
    return blocks


def gather_route(Q: int, R: int, n: int, d: int) -> tuple[str, int]:
    """The kernel :func:`gather_distance` launches for queries (Q, d), ids
    (Q, R) and a base (n, d), and its blocks: the pair kernel at every shape
    it takes (the rerank, a descent step, a layer start, the hubs scan), as
    ("pairs", blocks). Raises ValueError on a shape it cannot take."""
    return "pairs", pair_grid(Q, R, n, d)


def _check(queries, ids, base, metric, visited=None, generic=True):
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}; one of {sorted(METRIC_CODES)}")
    tensors = {"queries": queries, "ids": ids, "base": base}
    if visited is not None:
        tensors["visited"] = visited
    dev = queries.device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t, dt in (("queries", queries, torch.float32),
                        ("base", base, torch.float32),
                        ("ids", ids, torch.int32)):
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
    if queries.dim() != 2 or ids.dim() != 2 or base.dim() != 2:
        raise ValueError("queries (Q, d), ids (Q, R) and base (n, d) must be 2-D")
    Q, d = queries.shape
    n = base.shape[0]
    R = ids.shape[1]
    if ids.shape[0] != Q or base.shape[1] != d:
        raise ValueError(f"shape mismatch: queries {tuple(queries.shape)}, "
                         f"ids {tuple(ids.shape)}, base {tuple(base.shape)}")
    if n < 1 or (generic and (d > GENERIC_MAX_D or -(-R // 32) > MAX_R_TILES)):
        raise ValueError(f"unsupported shape: n={n} (>= 1), d={d} (<= {GENERIC_MAX_D}), "
                         f"R={R} (<= {32 * MAX_R_TILES})")
    pair_grid(Q, R, n, d)
    W = 0
    if visited is not None:
        if visited.dtype != torch.int32 or visited.dim() != 2:
            raise ValueError("visited must be a (Q, ceil(n/32)) int32 bitmap")
        W = visited.shape[1]
        if visited.shape[0] != Q or W < 1:
            raise ValueError(f"visited {tuple(visited.shape)} does not match Q={Q}")
    return Q, R, n, d, W


def _launch(queries, ids, base, visited, out_d, out_i, dims, metric):
    Q, R, n, d, W = dims
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    status = _entry()(
        queries.data_ptr(), ids.data_ptr(), base.data_ptr(),
        None if visited is None else visited.data_ptr(),
        out_d.data_ptr(), None if out_i is None else out_i.data_ptr(),
        Q, R, n, d, W, METRIC_CODES[metric], int(visited is not None), stream,
    )
    _build.check(status, "gather_distance_f32")


def gather_distance(queries: torch.Tensor, ids: torch.Tensor,
                    base: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """queries (Q, d) f32, ids (Q, R) i32, base (n, d) f32 -> (Q, R) f32
    distances; ids < 0 give +inf, ids past n - 1 read row n - 1. Runs the
    pair kernel (:func:`gather_route`)."""
    Q, R, n, d, _ = _check(queries, ids, base, metric, generic=False)
    gather_route(Q, R, n, d)
    out_d = torch.empty(ids.shape, dtype=torch.float32, device=queries.device)
    if Q * R == 0:
        return out_d
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        status = _pair_entry()(queries.data_ptr(), ids.data_ptr(), base.data_ptr(),
                               out_d.data_ptr(), Q, R, n, d, METRIC_CODES[metric], stream)
    _build.check(status, "gather_distance_pairs_f32")
    LAUNCHES["gather_distance"] += 1
    return out_d


def gather_distance_generic(queries: torch.Tensor, ids: torch.Tensor,
                            base: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """:func:`gather_distance` on the generic kernel (one warp per id, 4
    ids a warp in series, d <= GENERIC_MAX_D): the pair kernel's yardstick,
    bit for bit and in time. No path of the port calls it."""
    dims = _check(queries, ids, base, metric)
    out_d = torch.empty(ids.shape, dtype=torch.float32, device=queries.device)
    with torch.cuda.device(queries.device):
        _launch(queries, ids, base, None, out_d, None, dims, metric)
    LAUNCHES["gather_distance_generic"] += 1
    return out_d


def gather_distance_masked(queries: torch.Tensor, ids: torch.Tensor,
                           base: torch.Tensor, visited: torch.Tensor,
                           metric: str = "l2"):
    """As :func:`gather_distance`, plus the visited (Q, ceil(n/32)) int32
    bitmap: padding and visited ids come back as (+inf, -1). Returns
    (dists (Q, R) f32, masked ids (Q, R) i32). Runs the hop kernel."""
    Q, R, n, d, W = _check(queries, ids, base, metric, visited)
    out_d = torch.empty(ids.shape, dtype=torch.float32, device=queries.device)
    out_i = torch.empty(ids.shape, dtype=torch.int32, device=queries.device)
    if Q * R == 0:
        return out_d, out_i
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        status = _hop_entry()(queries.data_ptr(), ids.data_ptr(), base.data_ptr(),
                              visited.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                              Q, R, n, d, W, METRIC_CODES[metric], stream)
    _build.check(status, "gather_distance_hop_f32")
    LAUNCHES["gather_distance_masked"] += 1
    return out_d, out_i


def gather_distance_masked_generic(queries: torch.Tensor, ids: torch.Tensor,
                                   base: torch.Tensor, visited: torch.Tensor,
                                   metric: str = "l2"):
    """:func:`gather_distance_masked` on the generic kernel (one warp per
    id, 4 ids a warp in series): the hop kernel's yardstick, bit for bit
    and in time. No path of the port calls it."""
    dims = _check(queries, ids, base, metric, visited)
    out_d = torch.empty(ids.shape, dtype=torch.float32, device=queries.device)
    out_i = torch.empty(ids.shape, dtype=torch.int32, device=queries.device)
    with torch.cuda.device(queries.device):
        _launch(queries, ids, base, visited, out_d, out_i, dims, metric)
    LAUNCHES["gather_distance_masked_generic"] += 1
    return out_d, out_i
