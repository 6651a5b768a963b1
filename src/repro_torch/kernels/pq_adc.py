"""CUDA wrappers for the dense PQ asymmetric-distance scan.

Replace the Pallas kernel ``pq_adc`` (``src/repro/kernels/pq_adc.py``); the
reference's vmap over queries is the kernels' batch dimension. The source
is ``csrc/pq_adc.cu``; its header says what bounds the kernels on the H100
(bytes: the (Q, n) f32 scores; then the shared-memory lookups, M a score)
and how their design answers that. :func:`pq_adc` takes the route
:func:`scan_route` picks from the shapes: the interleaved kernel (lanes
over 16 queries whose LUTs are staged query-minor, half-warps one m apart,
so every warp lookup is one wavefront; a persistent grid, the scores out
through a per-warp transpose), or the generic kernel (a code row a thread
against a few staged LUTs) where the interleaved one does not pay or fit.
:func:`pq_adc_generic` runs the generic kernel at any shape, the
interleaved kernel's yardstick; no path of the port calls it. All sum
m = 0..M-1 as ``kernels.ref.pq_adc_ref`` sums, so they agree to the last
bit. These wrappers take CUDA tensors only; ``kernels.ops`` sends CPU
tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

QUERIES_PER_BLOCK = 8         # the generic kernel's staged LUTs: 64 KB at M=8, K=256
SMEM_BYTES = 232_448          # a block's shared memory on the H100
SMEM_FLOATS = SMEM_BYTES // 4
_INT_MAX = 2**31 - 1
# the interleaved kernel (csrc/pq_adc.cu): 16 queries a block, 16 warps,
# tiles of 64 rows, a transpose row of 66 floats, 16 bytes between the
# halves' code rows
QUERY_BLOCK = 16
SCAN_WARPS = 16
TILE_ROWS = 64
OUT_STRIDE = 66
HALF_GAP = 16
SCAN_M = (4, 8, 16)

# kernel launches by kernel: "pq_adc" the interleaved kernel, "pq_adc_generic"
# the generic one, by either wrapper (read and reset by chip_smoke.py)
LAUNCHES = {"pq_adc": 0, "pq_adc_generic": 0}

_fn = None
_scan_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("pq_adc").pq_adc_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _scan_entry():
    global _scan_fn
    if _scan_fn is None:
        fn = _build.load("pq_adc").pq_adc_interleaved_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _scan_fn = fn
    return _scan_fn


def scan_smem_bytes(M: int, K: int) -> int:
    """Shared memory of one interleaved block: the 16 queries' LUTs, and per
    warp its transpose and two code buffers (``scan_smem_bytes`` in
    csrc/pq_adc.cu)."""
    return (M * K * QUERY_BLOCK * 4
            + SCAN_WARPS * (QUERY_BLOCK * OUT_STRIDE * 4 + 2 * (TILE_ROWS * M + HALF_GAP)))


def scan_route(Q: int, M: int, K: int, codes_ptr: int) -> str:
    """"interleaved" where the interleaved kernel pays and fits: at least
    one full group of 16 queries, M of 4, 8 or 16 (codes read as words), a
    4-byte aligned code table, the block's shared memory within the
    H100's; else "generic" (a single LUT, Q < 16, another M, an unaligned
    table, LUTs past shared memory)."""
    if (Q < QUERY_BLOCK or M not in SCAN_M or codes_ptr % 4
            or scan_smem_bytes(M, K) > SMEM_BYTES):
        return "generic"
    return "interleaved"


def scan_grid(Q: int, n: int, sms: int) -> tuple[int, int]:
    """(groups of 16 queries, blocks a group) of the interleaved kernel's
    persistent grid: one block an SM, a group's blocks splitting the rows.
    Raises ValueError where the grid or the int32 indexing cannot take the
    shape."""
    groups = -(-Q // QUERY_BLOCK)
    parts = max(1, sms // groups)
    if max(Q, n) > _INT_MAX - TILE_ROWS or groups * parts > _INT_MAX:
        raise ValueError(f"shape exceeds the interleaved kernel's grid or int32 indexing: "
                         f"Q={Q} n={n}")
    return groups, parts


def _check(codes, luts):
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
    lb = luts if luts.dim() == 3 else luts.unsqueeze(0)
    Q, M, K = lb.shape
    n = codes.shape[0]
    if codes.shape[1] != M:
        raise ValueError(f"shape mismatch: codes {tuple(codes.shape)}, luts "
                         f"{tuple(luts.shape)}")
    if M < 1 or not 1 <= K <= 256 or M * K > SMEM_FLOATS:
        raise ValueError(f"unsupported LUT shape: M={M} (>= 1), K={K} (1..256: "
                         f"the codes are uint8), M*K <= {SMEM_FLOATS}")
    ref.check_codes_fit(codes, K)   # the kernels index the LUT by code unchecked
    return lb, Q, n, M, K


def _generic(codes, lb, Q, n, M, K):
    qb = max(1, min(QUERIES_PER_BLOCK, SMEM_FLOATS // (M * K)))
    if max(Q, n) > _INT_MAX or -(-Q // qb) > 65535:
        raise ValueError(f"shape exceeds the launch grid: Q={Q} n={n}")
    out = torch.empty((Q, n), dtype=torch.float32, device=codes.device)
    vec8 = M % 8 == 0 and codes.data_ptr() % 8 == 0
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        status = _entry()(codes.data_ptr(), lb.data_ptr(), out.data_ptr(),
                          Q, n, M, K, qb, int(vec8), stream)
    _build.check(status, "pq_adc_f32")
    LAUNCHES["pq_adc_generic"] += 1
    return out


def _interleaved(codes, lb, Q, n, M, K):
    _, parts = scan_grid(Q, n, torch.cuda.get_device_properties(codes.device)
                         .multi_processor_count)
    out = torch.empty((Q, n), dtype=torch.float32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        status = _scan_entry()(codes.data_ptr(), lb.data_ptr(), out.data_ptr(),
                               Q, n, M, K, parts, stream)
    _build.check(status, "pq_adc_interleaved_f32")
    LAUNCHES["pq_adc"] += 1
    return out


def pq_adc(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """codes (n, M) u8 against one LUT (M, K) f32 -> (n,) f32 ADC scores, or
    against a batch of LUTs (Q, M, K) -> (Q, n). Codes and LUTs must come
    from one PQ table: a code >= K raises. Runs the kernel of
    :func:`scan_route`."""
    lb, Q, n, M, K = _check(codes, luts)
    if scan_route(Q, M, K, codes.data_ptr()) == "interleaved":
        out = _interleaved(codes, lb, Q, n, M, K)
    else:
        out = _generic(codes, lb, Q, n, M, K)
    return out if luts.dim() == 3 else out[0]


def pq_adc_generic(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """:func:`pq_adc` on the generic kernel at any shape: the interleaved
    kernel's yardstick, bit for bit and in time. No path of the port calls
    it."""
    lb, Q, n, M, K = _check(codes, luts)
    out = _generic(codes, lb, Q, n, M, K)
    return out if luts.dim() == 3 else out[0]
