"""Carry the reference's state across to the port.

Takes numpy arrays as ``repro`` produces them (``np.asarray(graph.neighbors)``,
``.dists``, ``hubs`` through :func:`tensor`, the base, a uint32 visited or
tombstone bitmap, the sq8 and PQ tables, an ``HnswIndex``'s layer arrays,
a ``ForestIndex``'s planes, offsets and leaves, a ``MutableIndex``'s
state) and returns the port's tensors, tables, indexes, ``Searcher`` and
``MutableIndex``. uint32 bitmap words become int32 words bit for bit
(torch has no unsigned shift or scatter-add on the CPU);
:func:`bitmap_to_uint32` goes back. A saved index needs no carrying by
hand: ``core.io.load_index(path).to_searcher(device)`` reads an artifact
the reference wrote (and ``core.io.save_index`` writes one it reads).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..baselines.pq import PQIndex
from ..baselines.tree import ForestIndex
from .engine import Searcher
from .graph_index import HnswIndex, KnnGraph
from .mutable import MutableIndex
from .scorers import Sq8Index


def tensor(a, dtype: torch.dtype, device="cuda") -> torch.Tensor:
    """A copy of a numpy array (or array-like) as a contiguous tensor on
    ``device``."""
    np_dtype = {torch.float32: np.float32, torch.int32: np.int32,
                torch.uint8: np.uint8}[dtype]
    arr = np.array(a, dtype=np_dtype, order="C")
    return torch.from_numpy(arr).to(resolve_device(device))


def bitmap_from_uint32(words, device="cuda") -> torch.Tensor:
    """uint32 bitmap words (any shape) -> the same bits as int32 words."""
    arr = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(resolve_device(device))


def bitmap_to_uint32(words: torch.Tensor) -> np.ndarray:
    """int32 bitmap words -> the reference's uint32 words, bit for bit."""
    return words.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def graph_from_numpy(neighbors, dists=None, device="cuda") -> KnnGraph:
    """A reference ``KnnGraph`` (as numpy) -> the port's. Missing distances
    (diversified graphs carry NaN) stay NaN."""
    nbrs = tensor(neighbors, torch.int32, device)
    if dists is None:
        d = torch.full(nbrs.shape, float("nan"), device=nbrs.device)
    else:
        d = tensor(dists, torch.float32, device)
    return KnnGraph(neighbors=nbrs, dists=d)


def hnsw_from_numpy(layers_neighbors, layers_nodes, layers_slot, entry_point, levels,
                    device="cuda") -> HnswIndex:
    """The reference's ``HnswIndex`` (per-layer adjacency in global ids,
    node lists and id -> slot maps, the entry point and the levels, as
    numpy) -> the port's, on ``device``: the weights carried across for the
    hierarchy path."""
    def layers(arrs):
        return tuple(tensor(a, torch.int32, device) for a in arrs)

    return HnswIndex(layers_neighbors=layers(layers_neighbors),
                     layers_nodes=layers(layers_nodes),
                     layers_slot=layers(layers_slot),
                     entry_point=tensor(entry_point, torch.int32, device).reshape(()),
                     levels=tensor(levels, torch.int32, device))


def sq8_from_numpy(codes, scale, mn, device="cuda") -> Sq8Index:
    """The reference's ``Sq8Index`` (codes (n, d) uint8, scale and mn (d,)
    float32, as numpy) -> the port's."""
    return Sq8Index(codes=tensor(codes, torch.uint8, device),
                    scale=tensor(scale, torch.float32, device),
                    mn=tensor(mn, torch.float32, device))


def pq_index_from_numpy(codebooks, codes, rotation=None, device="cuda") -> PQIndex:
    """The reference's ``PQIndex`` (codebooks (M, K, dsub), codes (n, M)
    uint8, optional OPQ rotation (d, d), as numpy) -> the port's."""
    cb = tensor(codebooks, torch.float32, device)
    return PQIndex(codebooks=cb, codes=tensor(codes, torch.uint8, device),
                   M=cb.shape[0], K=cb.shape[1],
                   rotation=(None if rotation is None
                             else tensor(rotation, torch.float32, device)))


def forest_from_reference(planes, offsets, leaves, depth: int,
                          device="cuda") -> ForestIndex:
    """The reference's ``ForestIndex`` (planes (T, n_internal, d), offsets
    (T, n_internal), leaves (T, n_leaves, leaf_cap), as numpy) -> the
    port's."""
    return ForestIndex(planes=tensor(planes, torch.float32, device),
                       offsets=tensor(offsets, torch.float32, device),
                       leaves=tensor(leaves, torch.int32, device), depth=int(depth))


def searcher_from_numpy(base, neighbors, *, metric: str = "l2",
                        tombstones=None, rng_seed: int = 0, pq=None,
                        hierarchy: HnswIndex | None = None, hubs=None,
                        metadata: dict | None = None, device="cuda") -> Searcher:
    """A port ``Searcher`` over the reference's base and adjacency (and
    optionally its uint32 tombstone bitmap, a port ``PQIndex`` to attach, a
    port ``HnswIndex`` from :func:`hnsw_from_numpy`, the reference's hub
    list and its metadata columns, kept as numpy for filters)."""
    return Searcher(
        tensor(base, torch.float32, device),
        tensor(neighbors, torch.int32, device),
        metric=metric, rng_seed=rng_seed, pq=pq, hierarchy=hierarchy,
        hubs=None if hubs is None else tensor(hubs, torch.int32, device),
        tombstones=(None if tombstones is None
                    else bitmap_from_uint32(tombstones, device)),
        metadata=(None if metadata is None
                  else {name: np.asarray(col) for name, col in metadata.items()}),
    )


def mutable_from_numpy(state: dict, *, metric: str = "l2", rng_seed: int = 0,
                       insert_ef: int = 64, diversify: str = "none", max_keep: int = 0,
                       n_entries: int = 8, device="cuda") -> MutableIndex:
    """A reference ``MutableIndex``'s state -> the port's, to continue one
    history in the other package. ``state`` holds the reference's
    capacity-shaped host arrays as numpy (``base`` ``_base``, ``neighbors``
    ``_nbrs``, ``dists`` ``_dists``, ``alive`` ``_alive``, ``tombstones``
    ``_tomb``, uint32 words, and ``metadata`` its columns) and its numbers
    (``n_alloc``, ``capacity``, ``inserts_since_compact``,
    ``deletes_since_compact``, ``total_inserts``, ``insert_wall_s``,
    ``version``), the layout of the port's ``MutableIndex.state()``. The
    configuration (``max_keep`` as the reference resolved it) comes as
    keywords; the reference's ``jax.random`` key has no counterpart, and
    the port draws from ``rng_seed``."""
    return MutableIndex.from_state(state, metric=metric, rng_seed=rng_seed,
                                   insert_ef=insert_ef, diversify=diversify,
                                   max_keep=max_keep, n_entries=n_entries, device=device)
