"""Tiered base storage: where the float base lives, as the reference's
``src/repro/core/base_store.py``.

* ``device`` — the base is a tensor on the index's device and the rerank
  gathers rows there (the beam's own ``_finalize``; nothing changes).
* ``host``   — the base stays in a C-contiguous numpy array in host memory;
  the device keeps the compressed table and the adjacency.
* ``disk``   — the base lives in memory-mapped row-sharded ``.npy`` files
  (an artifact's shards through :meth:`BaseStore.from_shards`, or an
  in-memory base spilled to a temporary directory that :meth:`close`
  removes). Only the survivors' pages are read.

The host and disk tiers' only device traffic is the rerank's rows:
:meth:`BaseStore.gather_start` slices the top-``rerank`` survivor rows on
the host into a pinned staging buffer and issues one non-blocking copy on
a side stream; :meth:`StagedRows.wait` makes the current stream wait for
it. The staging buffer lives in the handle until the copy has been waited
on, and PyTorch's pinned-memory allocator does not hand it out again before
the copy has read it. A store on the CPU
(``device="cpu"``) has no copy. Nothing falls back: a failed pin or copy
raises.

Traffic is billed as the reference bills it: host rows ``row_bytes`` each,
disk rows in whole 4096-byte pages deduplicated per query (two survivors on
one page cost one page), with running totals ``gathered_rows`` and
``gathered_bytes``.

Rows may be stored at half width (``dtype="bf16"``): the bits of a
round-to-nearest-even cast, kept as uint16 in numpy (the port needs no
``ml_dtypes``) and viewed as ``torch.bfloat16`` on the way to the device,
where the rerank casts them to float32. float32 is what keeps the host and
disk tiers' answers bit-identical to the device tier's.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import weakref
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from .topk import INVALID, topk_smallest

PLACEMENTS = ("device", "host", "disk")

# storage dtype -> (numpy storage dtype, bytes/element); bf16 is kept as
# its uint16 bits
DTYPES = {
    "f32": (np.dtype(np.float32), 4),
    "bf16": (np.dtype(np.uint16), 2),
}

# the disk tier's billing quantum: an mmap fault moves whole pages
PAGE_BYTES = 4096

# rows per spilled shard (artifact sharding picks its own through save_index)
DEFAULT_SHARD_ROWS = 1 << 16


def check_placement(placement: str) -> str:
    if placement not in PLACEMENTS:
        raise ValueError(f"unknown base_placement {placement!r}; one of {PLACEMENTS}")
    return placement


def check_dtype(dtype: str) -> str:
    if dtype not in DTYPES:
        raise ValueError(f"unknown store_dtype {dtype!r}; one of {tuple(DTYPES)}")
    return dtype


def bf16_bits(x) -> np.ndarray:
    """float32 -> bfloat16 bits (uint16), rounded to nearest even; a NaN
    becomes the quiet NaN of its sign (0x7FC0 / 0xFFC0), as ``ml_dtypes``
    casts."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    out = ((u + (np.uint32(0x7FFF) + ((u >> 16) & 1))) >> 16).astype(np.uint16)
    nan = np.isnan(u.view(np.float32))
    if nan.any():
        out[nan] = np.where(u[nan] >> 31 == 1, 0xFFC0, 0x7FC0).astype(np.uint16)
    return out


def bf16_to_f32(bits) -> np.ndarray:
    """bfloat16 bits (uint16, or the reference's 2-byte void) -> float32,
    exactly."""
    b = np.asarray(bits)
    return (b.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def _storage(base, np_dtype) -> np.ndarray:
    """A base (tensor or array, float32) as a C-contiguous host array in the
    storage dtype."""
    if isinstance(base, torch.Tensor):
        base = base.detach().float().cpu().numpy()
    base = np.asarray(base, np.float32)
    if np_dtype == np.uint16:
        return bf16_bits(base)
    return np.ascontiguousarray(base)


def _as_torch(rows_np: np.ndarray, dtype: str) -> torch.Tensor:
    """Host rows in the storage dtype -> a tensor (bf16 bits viewed as
    ``torch.bfloat16``) sharing their memory."""
    if dtype == "bf16":
        return torch.from_numpy(rows_np.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(rows_np)


class StagedRows(NamedTuple):
    """Rows and their traffic on their way to the device. :meth:`wait`
    makes the current stream wait for the copy and returns them. The pinned
    host buffers ride here until then; PyTorch's pinned-memory allocator
    also records the copy's event, so a freed buffer is not handed out
    again before the copy has read it."""

    rows: torch.Tensor             # (Q, R, d) on the store's device
    bytes_touched: torch.Tensor    # (Q,) int32 tier traffic
    ready: object                  # torch.cuda.Event of the copy, or None
    staging: tuple | None          # the pinned sources of the copy

    def wait(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.rows.device)
            stream.wait_event(self.ready)
            # both were allocated on the side stream and are used here
            self.rows.record_stream(stream)
            self.bytes_touched.record_stream(stream)
        return self.rows, self.bytes_touched


class BaseStore:
    """The float base behind one placement. ``device`` wraps a tensor;
    ``host`` a host numpy array; ``disk`` a list of row-sharded mmap'd
    ``.npy`` files. Rows go to ``device`` (default: the base's own device
    where the base is a tensor, else ``cuda``)."""

    def __init__(self, base, placement: str = "device", dtype: str = "f32",
                 shard_rows: int = 0, device=None):
        self.placement = check_placement(placement)
        self.dtype = check_dtype(dtype)
        np_dtype, elem = DTYPES[dtype]
        if device is None:
            device = base.device if isinstance(base, torch.Tensor) else "cuda"
        self.device = resolve_device(device)
        self._dev = None
        self._host = None
        self._shards: list[np.ndarray] | None = None
        self._spill_dir: str | None = None
        self._stream = None
        if placement == "disk":
            base_np = _storage(base, np_dtype)
            self.n, self.d = base_np.shape
            self._spill(base_np, shard_rows or DEFAULT_SHARD_ROWS)
        elif placement == "host":
            self._host = _storage(base, np_dtype)
            self.n, self.d = self._host.shape
        else:
            arr = torch.as_tensor(base, device=self.device).float()
            self._dev = arr if dtype == "f32" else arr.to(torch.bfloat16)
            self.n, self.d = self._dev.shape
        self.row_bytes = self.d * elem
        # running totals (serving stats; per-query bytes ride the result)
        self.gathered_rows = 0
        self.gathered_bytes = 0

    @classmethod
    def from_shards(cls, shards, dtype: str = "f32", device="cuda") -> "BaseStore":
        """Adopt memory-mapped shard arrays (row-partitioned, equal d) as a
        ``disk`` store without copying (``io.open_base_shards``)."""
        self = cls.__new__(cls)
        self.placement = "disk"
        self.dtype = check_dtype(dtype)
        np_dtype, elem = DTYPES[dtype]
        shards = list(shards)
        if not shards:
            raise ValueError("from_shards needs at least one shard")
        self.device = resolve_device(device)
        self._dev = None
        self._host = None
        self._spill_dir = None
        self._stream = None
        self._shards = [s.view(np_dtype) if s.dtype != np_dtype else s for s in shards]
        self.d = int(self._shards[0].shape[1])
        rows = [int(s.shape[0]) for s in self._shards]
        self.n = sum(rows)
        self._starts = np.cumsum([0] + rows[:-1])
        self.row_bytes = self.d * elem
        self.gathered_rows = 0
        self.gathered_bytes = 0
        return self

    def _spill(self, base_np: np.ndarray, shard_rows: int) -> None:
        self._spill_dir = tempfile.mkdtemp(prefix="repro-basestore-")
        # the directory goes with the store even where close() is never called
        weakref.finalize(self, shutil.rmtree, self._spill_dir, True)
        paths = []
        for i, start in enumerate(range(0, self.n, shard_rows)):
            p = os.path.join(self._spill_dir, f"base_shard_{i:05d}.npy")
            np.save(p, base_np[start:start + shard_rows])
            paths.append(p)
        self._shards = [np.load(p, mmap_mode="r") for p in paths]
        rows = [int(s.shape[0]) for s in self._shards]
        self._starts = np.cumsum([0] + rows[:-1])

    def close(self) -> None:
        """Drop shard mmaps and remove a spilled directory (no-op for device
        and host stores and for adopted artifact shards)."""
        self._shards = None
        if self._spill_dir is not None:
            shutil.rmtree(self._spill_dir, ignore_errors=True)
            self._spill_dir = None

    @classmethod
    def wrap(cls, base, placement: str = "device", dtype: str = "f32") -> "BaseStore":
        if isinstance(base, BaseStore):
            if base.placement != placement:
                raise ValueError(f"BaseStore placement {base.placement!r} != "
                                 f"requested {placement!r}")
            if base.dtype != dtype:
                raise ValueError(f"BaseStore dtype {base.dtype!r} != requested {dtype!r}")
            return base
        return cls(base, placement, dtype=dtype)

    @property
    def nbytes(self) -> int:
        return self.n * self.row_bytes

    @property
    def shards(self) -> list | None:
        """The mmap'd shard arrays of a ``disk`` store (None otherwise)."""
        return self._shards

    @property
    def spill_dir(self) -> str | None:
        """The temporary directory of spilled shards (None when the store
        wraps an artifact's shards or is not disk-placed)."""
        return self._spill_dir

    def device_view(self) -> torch.Tensor:
        """The whole base on the device: only under ``device`` placement."""
        if self._dev is None:
            raise ValueError(
                f"base_placement={self.placement!r}: the float base is not "
                "device-resident; use gather(ids) for the rerank rows "
                "instead of device_view()")
        return self._dev

    def _gather_disk(self, safe: np.ndarray, out: np.ndarray) -> np.ndarray:
        """Row gather across shards into ``out`` (Q, R, d), storage dtype.
        Reads fault in only the touched pages of each shard."""
        shard_idx = np.searchsorted(self._starts, safe, side="right") - 1
        local = safe - self._starts[shard_idx]
        for si, shard in enumerate(self._shards):
            m = shard_idx == si
            if m.any():
                out[m] = shard[local[m]]
        return out

    def _disk_bytes(self, ids_np: np.ndarray) -> np.ndarray:
        """Per-query bytes billed in whole pages: the unique (shard, page)
        set each query's valid rows touch, times PAGE_BYTES."""
        safe = np.maximum(ids_np, 0).astype(np.int64)
        shard_idx = np.searchsorted(self._starts, safe, side="right") - 1
        local = safe - self._starts[shard_idx]
        first = local * self.row_bytes // PAGE_BYTES
        last = ((local + 1) * self.row_bytes - 1) // PAGE_BYTES
        span = int((last - first).max()) + 1 if ids_np.size else 1
        # (Q, R, span) page grid, invalid rows and overhang masked out
        grid = first[..., None] + np.arange(span)[None, None, :]
        ok = (grid <= last[..., None]) & (ids_np >= 0)[..., None]
        key = shard_idx[..., None].astype(np.int64) << 40 | grid
        out = np.zeros(ids_np.shape[0], np.int64)
        for q in range(ids_np.shape[0]):
            out[q] = np.unique(key[q][ok[q]]).size * PAGE_BYTES
        return out

    def gather_start(self, ids: torch.Tensor) -> StagedRows:
        """ids (Q, R) int32 (INVALID < 0 allowed) -> rows (Q, R, d) on the
        store's device, in flight, and bytes_touched (Q,) int32. INVALID ids
        fetch row 0; the rerank scores them +inf.

        Host and disk: the ids come to the host (they are the traversal's
        output), the rows are sliced into a pinned buffer and copied on a
        side stream with one non-blocking copy. Device: an on-device gather,
        no tier traffic."""
        if self._dev is not None:
            rows = self._dev[ids.clamp(min=0).long()]
            return StagedRows(rows, torch.zeros(ids.shape[:1], dtype=torch.int32,
                                                device=ids.device), None, None)
        ids_np = ids.detach().cpu().numpy()
        safe = np.maximum(ids_np, 0)
        valid = (ids_np >= 0).sum(axis=1, dtype=np.int64)
        np_dtype, _ = DTYPES[self.dtype]
        shape = ids_np.shape + (self.d,)
        cuda = self.device.type == "cuda"
        if cuda:
            staging = torch.empty(shape, dtype=torch.int16 if self.dtype == "bf16"
                                  else torch.float32, pin_memory=True)
            out = staging.numpy().view(np_dtype)
        else:
            staging, out = None, np.empty(shape, np_dtype)
        if self._shards is not None:
            self._gather_disk(safe, out)
            bts = self._disk_bytes(ids_np)
        else:
            np.take(self._host, safe, axis=0, out=out)
            bts = valid * self.row_bytes
        self.gathered_rows += int(valid.sum())
        self.gathered_bytes += int(bts.sum())
        bts_t = torch.from_numpy(bts.astype(np.int32))
        if not cuda:
            return StagedRows(_as_torch(out, self.dtype), bts_t, None, None)
        bts_t = bts_t.pin_memory()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        src = staging.view(torch.bfloat16) if self.dtype == "bf16" else staging
        # the side stream's fresh allocation must not overtake work already
        # queued on the current stream with memory it may recycle
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            dst = src.to(self.device, non_blocking=True)
            bts_dev = bts_t.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return StagedRows(dst, bts_dev, ready, (staging, bts_t))

    def gather(self, ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(rows (Q, R, d) on the store's device, bytes_touched (Q,) int32),
        ready for the current stream (:meth:`gather_start`, waited on)."""
        return self.gather_start(ids).wait()


def rerank_gathered(queries: torch.Tensor, cand: torch.Tensor, rows: torch.Tensor,
                    k: int, metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
    """Exact rerank over gathered rows: cand (Q, r) ids, rows (Q, r, d) ->
    (dists (Q, k), ids (Q, k)) ascending.

    The staged rows are the base of one ``ops.gather_distance`` call, with
    ids ``q * r + j`` (INVALID where ``cand`` is): the pair kernel on the
    card, the plain version on the CPU, the same call the device tier's
    rerank makes over the device base, so every placement gives the same
    bits. bf16 rows are cast to float32 first. INVALID candidates score
    +inf and never win."""
    from ..kernels import ops

    Q, r, d = rows.shape
    flat = rows.reshape(Q * r, d).float().contiguous()
    slot = (torch.arange(Q, dtype=torch.int32, device=cand.device)[:, None] * r
            + torch.arange(r, dtype=torch.int32, device=cand.device)[None, :])
    ids = torch.where(cand >= 0, slot, torch.full_like(slot, INVALID))
    exact = ops.gather_distance(queries, ids, flat, metric=metric)
    dd, sel = topk_smallest(exact, k)
    return dd, cand.gather(1, sel)
