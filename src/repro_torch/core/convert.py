"""Carry the reference's state across to the port.

Takes numpy arrays as ``repro`` produces them (``np.asarray(graph.neighbors)``,
``.dists``, ``hubs`` through :func:`tensor`, the base, a uint32 visited or
tombstone bitmap) and returns the port's tensors and ``Searcher``. uint32 bitmap words become
int32 words bit for bit (torch has no unsigned shift or scatter-add on the
CPU); :func:`bitmap_to_uint32` goes back.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .engine import Searcher
from .graph_index import KnnGraph


def tensor(a, dtype: torch.dtype, device="cuda") -> torch.Tensor:
    """A copy of a numpy array (or array-like) as a contiguous tensor on
    ``device``."""
    np_dtype = {torch.float32: np.float32, torch.int32: np.int32}[dtype]
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


def searcher_from_numpy(base, neighbors, *, metric: str = "l2",
                        tombstones=None, rng_seed: int = 0,
                        device="cuda") -> Searcher:
    """A port ``Searcher`` over the reference's base and adjacency (and
    optionally its uint32 tombstone bitmap)."""
    return Searcher(
        tensor(base, torch.float32, device),
        tensor(neighbors, torch.int32, device),
        metric=metric, rng_seed=rng_seed,
        tombstones=(None if tombstones is None
                    else bitmap_from_uint32(tombstones, device)),
    )
