"""Annoy-style random-projection tree forest, the paper's tree baseline, as
the reference's ``src/repro/baselines/tree.py``.

Each tree splits the data recursively with a random hyperplane through a
random base point's projection (Annoy uses two-means directions; random
gaussian hyperplanes give the same asymptotics and vectorize cleanly).
Trees are *complete* with a fixed depth, so the whole forest is three dense
tensors. A query descends every tree (batched sign tests), unions the
reached leaves' points, and reranks them exactly through
``ops.gather_distance`` (the pair kernel on the card).

Planes and threshold points draw from a ``torch.Generator``, or are
injected per tree (the tests hand the build the reference's draws). Sign
tests sum in another order than the reference's, so a point or query that
lies within rounding of a hyperplane may take the other branch: such
near-ties are counted by the tests, never hidden.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core.topk import INVALID, topk_smallest

ROUTE_BYTES = 1 << 28   # a routing block's gathered (rows, d) planes


class ForestIndex(NamedTuple):
    planes: torch.Tensor   # (T, n_internal, d) hyperplane normals
    offsets: torch.Tensor  # (T, n_internal) thresholds
    leaves: torch.Tensor   # (T, n_leaves, leaf_cap) point ids, -1 padded
    depth: int


def default_depth(n: int) -> int:
    """ceil(log2(max(n / 64, 2))), in float32 as the reference computes it."""
    return max(1, int(np.ceil(np.log2(np.float32(max(n / 64, 2))))))


def default_leaf_cap(n: int, depth: int) -> int:
    return max(16, int(2.5 * n / 2**depth))


def _descend(x: torch.Tensor, planes: torch.Tensor, offsets: torch.Tensor,
             depth: int) -> torch.Tensor:
    """Heap node of each row of x (m, d) after ``depth`` sign tests against
    one tree's planes (n_internal, d): 2 * node + 1 + (x . plane > offset)."""
    node = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for _ in range(depth):
        go_right = (planes[node] * x).sum(-1) > offsets[node]
        node = 2 * node + 1 + go_right.to(torch.int64)
    return node


def _build_tree(base: torch.Tensor, depth: int, leaf_cap: int, planes: torch.Tensor,
                sample_ids: torch.Tensor):
    """One complete RP-tree: route all points level by level (strict >),
    then bucket by leaf with a stable sort and a per-leaf rank, at most
    ``leaf_cap`` points a leaf."""
    n, d = base.shape
    n_internal = 2**depth - 1
    offsets = (planes * base[sample_ids.long()]).sum(1)
    block = max(1, ROUTE_BYTES // (4 * d))
    leaf_of = torch.cat([_descend(base[lo:lo + block], planes, offsets, depth)
                         for lo in range(0, n, block)]) - n_internal
    sorted_leaf, order = torch.sort(leaf_of, stable=True)
    first = torch.searchsorted(sorted_leaf, sorted_leaf)
    slot = torch.arange(n, device=base.device) - first
    keep = slot < leaf_cap
    leaves = torch.full((2**depth, leaf_cap), INVALID, dtype=torch.int32,
                        device=base.device)
    leaves[sorted_leaf[keep], slot[keep]] = order[keep].to(torch.int32)
    return offsets, leaves


def build_forest(base: torch.Tensor, n_trees: int = 8, depth: int | None = None,
                 leaf_cap: int | None = None, seed: int = 0,
                 planes: Sequence[torch.Tensor] | None = None,
                 sample_ids: Sequence[torch.Tensor] | None = None) -> ForestIndex:
    """``n_trees`` trees on ``base``'s device. Each tree draws unit-norm
    gaussian planes (n_internal, d) and threshold points (n_internal,) from
    a generator seeded with ``seed``, unless ``planes`` and ``sample_ids``
    (one per tree) are given."""
    n, d = base.shape
    base = base.float().contiguous()
    if depth is None:
        depth = default_depth(n)
    if leaf_cap is None:
        leaf_cap = default_leaf_cap(n, depth)
    n_internal = 2**depth - 1
    if planes is None:
        gen = torch.Generator(device=base.device).manual_seed(seed)
        planes, sample_ids = [], []
        for _ in range(n_trees):
            p = torch.randn((n_internal, d), generator=gen, device=base.device)
            planes.append(p / torch.linalg.norm(p, dim=1, keepdim=True))
            sample_ids.append(torch.randint(0, n, (n_internal,), generator=gen,
                                            device=base.device))
    planes = [p.to(base.device, torch.float32) for p in planes]
    trees = [_build_tree(base, depth, leaf_cap, p, s.to(base.device))
             for p, s in zip(planes, sample_ids)]
    return ForestIndex(planes=torch.stack(planes),
                       offsets=torch.stack([o for o, _ in trees]),
                       leaves=torch.stack([lv for _, lv in trees]),
                       depth=depth)


def forest_candidates(queries: torch.Tensor, index: ForestIndex) -> torch.Tensor:
    """(Q, T * leaf_cap) int32: the union of the leaves each query reaches,
    sorted, repeats and padding set INVALID."""
    T, n_internal, _ = index.planes.shape
    Q = queries.shape[0]
    queries = queries.float()
    leaf = torch.stack([_descend(queries, index.planes[t], index.offsets[t], index.depth)
                        for t in range(T)], dim=1) - n_internal          # (Q, T)
    tree = torch.arange(T, device=queries.device)[None, :]
    cand = index.leaves[tree, leaf].reshape(Q, -1)
    cand, _ = torch.sort(cand, dim=1)
    dup = torch.zeros_like(cand, dtype=torch.bool)
    dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
    return cand.masked_fill(dup, INVALID).contiguous()


def forest_search(queries: torch.Tensor, base: torch.Tensor, index: ForestIndex,
                  k: int = 1):
    """Descend all trees, union leaf candidates, exact (l2) rerank. Returns
    (dists (Q, k), ids (Q, k), comps (Q,)): comps = valid candidates +
    T * depth sign tests."""
    from ..kernels import ops

    T = index.planes.shape[0]
    cand = forest_candidates(queries, index)
    exact = ops.gather_distance(queries.float().contiguous(), cand, base)   # inf at -1
    dd, jj = topk_smallest(exact, k)
    ids = cand.gather(1, jj)
    comps = (cand >= 0).sum(dim=1).to(torch.int32) + T * index.depth
    return dd, ids, comps
