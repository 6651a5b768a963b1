"""CUDA wrapper for the NN-Descent scoring pass ``gather_distance_pool``.

Replaces the Pallas kernel ``gather_distance``
(``src/repro/kernels/gather_distance.py``) where the local join calls it with
the base's own rows as queries. The source is ``csrc/gather_distance_pool.cu``;
its header says what bounds the pass on the H100 (bytes: one random row a
scored pair) and how the design answers that (windows of rows whose queries
and outputs stay in L2, their pairs partitioned by candidate bucket so each
bucket's rows are staged once a window, 8-lane groups scoring 2 rows each).
The distances have the bits of ``gather_distance.cu``'s. One call launches
4 kernels (hist, scan, scatter, score) per group of windows.

:func:`pool_plan` chooses the windows, buckets and groups from n, d, C and
the card's L2 size; it is plain Python, so the CPU tests check that it
covers every pair once. Where staging does not pay (a window holds fewer
pairs than the base has rows) or does not fit (more than ``MAX_BUCKETS``
buckets, rows per bucket or pairs per window past an entry's bits), the
plan is None and the pass is one launch of the direct kernel, which scores
every pair in place. Together they take every shape the generic gather
takes (d <= ``GENERIC_MAX_D``). The wrapper takes CUDA tensors only; ``kernels.ops``
sends CPU tensors to ``ref.gather_distance_pool_ref``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .gather_distance import GENERIC_MAX_D, METRIC_CODES

MAX_ROWS_LOG = 9         # R = 2**log_rows <= 512 rows a bucket
MAX_BUCKETS = 8192       # a chunk's histogram lives in 32 KB of shared memory
STAGE_BYTES = 32 * 1024  # a bucket's rows staged in shared memory, preferred
MAX_STAGE_BYTES = 200 * 1024
L2_SHARE = 0.5           # of the L2 for a window's query rows and outputs
GROUP_PAIRS = 1 << 26    # entries a call holds (256 MB of int32)
CHUNK_PAIRS = 40960      # pairs a hist / scatter block (scatter sorts them in
                         # shared memory: 4 * (chunk + 2 * n_buckets) <= 227 KB)
KERNELS_A_CALL = 4       # hist, scan, scatter, score

# kernel launches (read and reset by chip_smoke.py)
LAUNCHES = {"gather_distance_pool": 0}

_fn = None


class PoolPlan(NamedTuple):
    window: int      # V vertices a window; the last window may be shorter
    n_windows: int
    group: int       # windows a C call (one launch of each kernel)
    log_rows: int    # R = 2**log_rows base rows a candidate bucket
    n_buckets: int
    chunk: int       # pairs a hist / scatter block
    pos_bits: int    # an entry packs (row in bucket << pos_bits) | pair in window
    div_magic: int   # pair // C == (pair * div_magic) >> div_shift
    div_shift: int

    def calls(self):
        """(first window, windows) of each C call, in order."""
        return [(w0, min(self.group, self.n_windows - w0))
                for w0 in range(0, self.n_windows, self.group)]


def _log2_ceil(x: int) -> int:
    return max(0, (x - 1).bit_length())


def pool_plan(n: int, d: int, C: int, l2_bytes: int) -> PoolPlan | None:
    """Windows, buckets and groups for an (n, d) base and an (n, C) pool on
    a card with ``l2_bytes`` of L2, or None where the pass goes to the
    direct kernel. Raises on a shape neither kernel takes."""
    if n < 1 or d < 1 or C < 1:
        raise ValueError(f"empty shape: n={n}, d={d}, C={C}")
    if d > GENERIC_MAX_D or n > 2**31 - 1:
        raise ValueError(f"unsupported shape: d={d} (<= {GENERIC_MAX_D}), n={n} (< 2**31)")
    # buckets: as many rows as fit STAGE_BYTES, more if n needs fewer buckets
    fit = max(0, (STAGE_BYTES // (4 * d)).bit_length() - 1)
    log_rows = max(min(fit, MAX_ROWS_LOG), _log2_ceil(-(-n // MAX_BUCKETS)))
    if log_rows > MAX_ROWS_LOG or (4 * d) << log_rows > MAX_STAGE_BYTES:
        return None
    n_buckets = -(-n // (1 << log_rows))
    pos_bits = 31 - log_rows
    window = min(n, (1 << pos_bits) // C, int(L2_SHARE * l2_bytes) // (4 * (C + d)))
    if window * C < n:   # a staged bucket would serve fewer pairs than its rows
        return None
    n_windows = -(-n // window)
    group = max(1, min(n_windows, GROUP_PAIRS // (window * C), 65535))
    magic, shift = div_magic(C, pos_bits)
    return PoolPlan(window, n_windows, group, log_rows, n_buckets,
                    min(CHUNK_PAIRS, window * C), pos_bits, magic, shift)


def div_magic(C: int, bits: int) -> tuple[int, int]:
    """(m, s) with (x * m) >> s == x // C for every 0 <= x < 2**bits
    (Granlund and Montgomery, PLDI 1994, Theorem 4.2): s = bits + ceil(log2
    C), m = ceil(2**s / C); x * m < 2**64 for bits <= 31."""
    shift = bits + _log2_ceil(C)
    return -(-(1 << shift) // C), shift


def _entry():
    global _fn
    if _fn is None:
        lib = _build.load("gather_distance_pool")
        staged, direct = lib.gather_distance_pool_f32, lib.gather_distance_pool_direct_f32
        staged.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_uint64]
                           + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        direct.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        staged.restype = direct.restype = ctypes.c_int
        _fn = staged, direct
    return _fn


def gather_distance_pool(base: torch.Tensor, pool: torch.Tensor,
                         metric: str = "l2") -> torch.Tensor:
    """base (n, d) f32, pool (n, C) i32 -> (n, C) f32: the distance from
    base[v] to base[pool[v, j]]; ids < 0 give +inf, ids >= n read row n-1."""
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}; one of {sorted(METRIC_CODES)}")
    if base.dtype != torch.float32 or pool.dtype != torch.int32:
        raise ValueError(f"base must be torch.float32 and pool torch.int32, got "
                         f"{base.dtype} and {pool.dtype}")
    if base.dim() != 2 or pool.dim() != 2 or pool.shape[0] != base.shape[0]:
        raise ValueError(f"base (n, d) and pool (n, C) must be 2-D with one row "
                         f"a vertex: {tuple(base.shape)}, {tuple(pool.shape)}")
    for name, t in (("base", base), ("pool", pool)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("base", base), ("pool", pool)):
        if t.device.type != "cuda" or t.device != base.device:
            raise ValueError(f"{name} must be a CUDA tensor on {base.device}, "
                             f"got {t.device}")
    (n, d), C = base.shape, pool.shape[1]
    out = torch.empty((n, C), dtype=torch.float32, device=base.device)
    if n == 0 or C == 0:
        return out
    l2 = torch.cuda.get_device_properties(base.device).L2_cache_size
    plan = pool_plan(n, d, C, l2)
    with torch.cuda.device(base.device):
        stream = torch.cuda.current_stream(base.device).cuda_stream
        if plan is None:
            status = _entry()[1](base.data_ptr(), pool.data_ptr(), out.data_ptr(), n, d, C,
                                 METRIC_CODES[metric], stream)
            _build.check(status, "gather_distance_pool_direct_f32")
            LAUNCHES["gather_distance_pool"] += 1
            return out
        entries = torch.empty(plan.group * plan.window * C, dtype=torch.int32,
                              device=base.device)
        cells = torch.empty((3, plan.group * plan.n_buckets), dtype=torch.int32,
                            device=base.device)
        for w0, g in plan.calls():
            status = _entry()[0](
                base.data_ptr(), pool.data_ptr(), out.data_ptr(), entries.data_ptr(),
                cells[0].data_ptr(), cells[1].data_ptr(), cells[2].data_ptr(),
                n, d, C, plan.window, w0, g, plan.log_rows, plan.n_buckets,
                plan.chunk, plan.pos_bits, plan.div_magic, plan.div_shift,
                METRIC_CODES[metric], stream)
            _build.check(status, "gather_distance_pool_f32")
            LAUNCHES["gather_distance_pool"] += KERNELS_A_CALL
    return out
