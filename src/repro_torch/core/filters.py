"""Per-query predicate filtering and multi-tenant namespaces, as the
reference's ``src/repro/core/filters.py``.

A :class:`FilterSpec` names a predicate (tenant id, categorical tags, a time
range, an explicit denylist). :func:`compile_filter` evaluates it once, on
the host in numpy, against the index's metadata columns into a packed
``(ceil(n/32),)`` deny bitmap in the beam core's visited layout (bit ``i &
31`` of word ``i >> 5``). ``beam_search(deny=...)`` ORs it into every
query's initial visited set, so a denied id is never scored, never expanded
and never returned, under every scorer and placement: the mask epilogue of
the hop kernels is the one place ids become distances.

The port's words are int32 holding the reference's uint32 bits
(:func:`pack_bitmap` returns the uint32 words, as the reference's does;
``CompiledFilter.deny`` holds them as int32). A filter too selective to
traverse routes to an exact scan of the allowed ids
(``engine.filtered_brute_cutoff``, ``Searcher._filtered_brute``).

:func:`remap_denied_seeds` redraws denied seeds from the allowed set. The
reference folds the row index into a ``jax.random`` key; the port hashes
(seed, row index, slot) as its restart draws do
(``beam_search.restart_draws``), so a row padded into a larger batch
redraws as a direct search on it does. The draws differ from the
reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from .topk import INVALID

# metadata column names the predicate fields read
COL_TENANT = "tenant"
COL_TAG = "tag"
COL_TIMESTAMP = "timestamp"

# mixed into the seed-redraw keys, so a filtered search never replays its
# restart draws as seeds (the reference's fold constant, "FIXT")
_SEED_FOLD = 0x46495854


class FilterSpec(NamedTuple):
    """One search-time predicate; fields AND together and an all-default
    spec allows everything. Hashable, so it keys the Searcher's cache.

    * ``tenant`` — keep ids whose ``metadata["tenant"]`` equals this;
    * ``tags_any`` — keep ids whose ``metadata["tag"]`` is any of these;
    * ``time_range`` — ``(lo, hi)`` inclusive bounds on
      ``metadata["timestamp"]``;
    * ``deny_ids`` — an explicit denylist (no metadata needed).
    """

    tenant: int | None = None
    tags_any: tuple = ()
    time_range: tuple | None = None
    deny_ids: tuple = ()


class CompiledFilter(NamedTuple):
    """A FilterSpec evaluated against one index's metadata, as tensors on
    the index's device."""

    deny: torch.Tensor         # (ceil(n/32),) int32 words, denied ids set
    n_allowed: int             # how many ids survive the predicate
    cum: torch.Tensor          # (n,) int32 inclusive prefix count of allowed
                               # ids: maps a draw in [0, n_allowed) to an id
    allowed_ids: torch.Tensor  # (P,) int32 allowed ids ascending, INVALID-
                               # padded to the next power of two


def pack_bitmap(bits) -> np.ndarray:
    """(n,) bool -> (ceil(n/32),) packed uint32, bit ``i & 31`` of word
    ``i >> 5``."""
    bits = np.asarray(bits, bool)
    w = (bits.shape[0] + 31) // 32
    pad = np.zeros(w * 32, bool)
    pad[: bits.shape[0]] = bits
    words = pad.reshape(w, 32).astype(np.uint32)
    return (words << np.arange(32, dtype=np.uint32)[None, :]).sum(axis=1, dtype=np.uint32)


def unpack_bitmap(words, n: int) -> np.ndarray:
    """(W,) packed words (uint32, or the port's int32 tensor) -> (n,) bool."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    words = np.asarray(words)
    words = words.view(np.uint32) if words.dtype == np.int32 else words.astype(np.uint32)
    bits = (words[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    return bits.reshape(-1)[:n].astype(bool)


def bitmap_get(bitmap: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Read bits for ``ids`` from a (W,) int32 packed bitmap; ids < 0 read
    False. The shift is arithmetic; bit 0 of the result is the tested bit."""
    safe = ids.clamp(min=0)
    word = bitmap[torch.clamp(safe >> 5, max=bitmap.shape[0] - 1).long()]
    return (((word >> (safe & 31)) & 1) > 0) & (ids >= 0)


def _column(metadata, name: str, n: int) -> np.ndarray:
    if not metadata or name not in metadata:
        have = sorted(metadata) if metadata else []
        raise ValueError(
            f"filter needs metadata column {name!r} but this index carries "
            f"{have} — attach it at build time (Searcher(metadata=...)) or "
            f"persist it in the artifact"
        )
    col = np.asarray(metadata[name])
    if col.ndim != 1 or col.shape[0] < n:
        raise ValueError(f"metadata column {name!r} must be (n>={n},), got {col.shape}")
    return col[:n]


def compile_filter(spec: FilterSpec, metadata, n: int, dead=None,
                   device="cuda") -> CompiledFilter:
    """Evaluate ``spec`` against ``metadata`` (dict of (n,) columns) on the
    host, as the reference does, and put the result on ``device``.
    ``dead`` (optional packed tombstone words, uint32 or the port's int32)
    is taken out of the allowed set, so ``n_allowed``, the seed-redraw map
    and the exact-scan route never name a deleted id."""
    allow = np.ones(n, bool)
    if spec.tenant is not None:
        allow &= _column(metadata, COL_TENANT, n) == spec.tenant
    if spec.tags_any:
        allow &= np.isin(_column(metadata, COL_TAG, n), np.asarray(spec.tags_any))
    if spec.time_range is not None:
        lo, hi = spec.time_range
        ts = _column(metadata, COL_TIMESTAMP, n)
        allow &= (ts >= lo) & (ts <= hi)
    if spec.deny_ids:
        ids = np.asarray(spec.deny_ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            raise ValueError(f"deny_ids must lie in [0, {n}), got range "
                             f"[{ids.min()}, {ids.max()}]")
        allow[ids] = False
    if dead is not None:
        allow &= ~unpack_bitmap(dead, n)

    n_allowed = int(allow.sum())
    P = max(1, 1 << max(0, n_allowed - 1).bit_length())
    padded = np.full(P, INVALID, np.int32)
    padded[:n_allowed] = np.nonzero(allow)[0]
    dev = resolve_device(device)
    return CompiledFilter(
        deny=torch.from_numpy(pack_bitmap(~allow).view(np.int32)).to(dev),
        n_allowed=n_allowed,
        cum=torch.from_numpy(np.cumsum(allow, dtype=np.int32)).to(dev),
        allowed_ids=torch.from_numpy(padded).to(dev),
    )


def seed_draws(seed: int, Q: int, E: int, n_allowed: int, device) -> torch.Tensor:
    """(Q, E) int32 draws in [0, n_allowed): slot j of row i is a hash of
    (seed, i, j), a function of the row index, never of the batch shape."""
    from .beam_search import _M32, _mix32, restart_draws

    rows = torch.arange(Q, dtype=torch.int64, device=device)
    key = _mix32(torch.tensor((seed ^ _SEED_FOLD) & _M32, dtype=torch.int64, device=device))
    keys = _mix32(key ^ _mix32((rows + 0x61C88647) & _M32))
    return restart_draws(keys, torch.zeros_like(rows), E, n_allowed)


def remap_denied_seeds(entries: torch.Tensor, cf: CompiledFilter, seed: int) -> torch.Tensor:
    """Replace denied seed ids with uniform draws from the allowed set
    (:func:`seed_draws` mapped to ids through the prefix count) and dedup
    each row. With nothing allowed the seeds stay: the scorer masks them
    all and every row returns empty with zero comparisons."""
    if cf.n_allowed == 0:
        return entries
    from .beam_search import dedup_rows

    Q, E = entries.shape
    denied = bitmap_get(cf.deny, entries)
    r = seed_draws(seed, Q, E, cf.n_allowed, entries.device)
    draws = torch.searchsorted(cf.cum, r + 1).to(torch.int32)
    return dedup_rows(torch.where(denied, draws, entries.to(torch.int32)))
