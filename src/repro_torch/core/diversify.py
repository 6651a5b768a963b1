"""Graph diversification — the paper's hybrid scheme (Sec. III/IV).

* **GD** (HNSW's occlusion heuristic, paper Fig. 2): keep candidate c iff
  d(v,c) < d(s,c) for every already-kept s; at most L/2 survivors; then union
  with reverse edges ("KGraph+GD").

Each vertex's candidate geometry is an (L, L) distance matrix; a block of
vertices is one batched ``ops.distance_matrix`` call (one kernel launch for
the whole block instead of one per vertex). The greedy selection is a Python
loop over the L candidate slots, vectorized across every vertex of the
block. DPG comes with a later slice of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .graph_index import KnnGraph
from .topk import INVALID, sort_by_distance

GD_BLOCK = 1 << 16   # vertices whose (L, L) matrices one launch computes

_INT32_MAX = 2**31 - 1


# -- reverse-edge union -------------------------------------------------------


class ReverseUnionStats(NamedTuple):
    """Edge accounting of one reverse-edge union.

    candidates   : valid forward edges = reverse-edge candidates offered
    dropped_slot : candidates that overflowed the r reverse slots a target
                   row reserves
    dropped_cap  : surviving unique ids evicted by the final max_degree
                   truncation
    """

    candidates: int
    dropped_slot: int
    dropped_cap: int

    @property
    def dropped(self) -> int:
        return self.dropped_slot + self.dropped_cap


def add_reverse_edges_with_stats(neighbors: torch.Tensor, max_degree: int):
    """Union adjacency with its reverse edges, capped at max_degree.

    Slot assignment is deterministic: incoming edges are ranked by source id
    (stable sort + cumcount), overflow beyond r reverse slots is dropped and
    counted. Returns (adjacency (n, max_degree) int32, ReverseUnionStats)."""
    n, r = neighbors.shape
    dev = neighbors.device
    src = torch.arange(n, device=dev, dtype=torch.int32)[:, None].expand(n, r).reshape(-1)
    tgt = neighbors.reshape(-1)
    valid = tgt >= 0
    tgt_s = torch.where(valid, tgt, torch.full_like(tgt, n))  # invalid -> scratch row

    tgt_sorted, order = torch.sort(tgt_s, stable=True)
    src_sorted = src[order]
    # first occurrence position of each target = scatter-min of positions
    pos = torch.arange(tgt_sorted.shape[0], device=dev, dtype=torch.int32)
    first = torch.full((n + 1,), _INT32_MAX, dtype=torch.int32, device=dev)
    first.scatter_reduce_(0, tgt_sorted.long(), pos, reduce="amin")
    slot = pos - first[tgt_sorted.long()]

    n_rev = r  # reserve up to r reverse slots per vertex before the cap
    keep = (slot < n_rev) & (tgt_sorted < n)
    rev = torch.full((n * n_rev,), INVALID, dtype=torch.int32, device=dev)
    rev[(tgt_sorted.long() * n_rev + slot.long())[keep]] = src_sorted[keep]
    rev = rev.view(n, n_rev)

    merged = torch.cat([neighbors, rev], dim=1)
    # dedup by id per row (distance-free): sort ids, mask repeats, compact by
    # moving INVALID to the end (stable, so the sorted order is kept)
    ids_sorted, _ = torch.sort(merged, dim=1)
    dup = torch.zeros_like(ids_sorted, dtype=torch.bool)
    dup[:, 1:] = ids_sorted[:, 1:] == ids_sorted[:, :-1]
    ids_sorted = ids_sorted.masked_fill(dup | (ids_sorted < 0), INVALID)
    is_pad = (ids_sorted == INVALID).to(torch.int8)
    _, order2 = torch.sort(is_pad, dim=1, stable=True)
    compact = ids_sorted.gather(1, order2)
    n_valid = int(valid.sum())
    stats = ReverseUnionStats(
        candidates=n_valid,
        dropped_slot=n_valid - int(keep.sum()),
        dropped_cap=int((compact[:, max_degree:] != INVALID).sum()),
    )
    return compact[:, :max_degree], stats


def add_reverse_edges(neighbors: torch.Tensor, max_degree: int) -> torch.Tensor:
    """Reverse-edge union without the accounting."""
    merged, _ = add_reverse_edges_with_stats(neighbors, max_degree)
    return merged


# -- GD: occlusion pruning (HNSW heuristic) -----------------------------------


def _occlusion_select(cand_d: torch.Tensor, pair_d: torch.Tensor,
                      valid: torch.Tensor, max_keep: int) -> torch.Tensor:
    """Vertices (B,): cand_d (B, L) sorted asc, pair_d (B, L, L) -> keep mask
    (B, L). Candidate j is occluded if some kept s has d(s, c_j) <= d(v, c_j)."""
    B, L = cand_d.shape
    keep = torch.zeros((B, L), dtype=torch.bool, device=cand_d.device)
    count = torch.zeros((B,), dtype=torch.int32, device=cand_d.device)
    for j in range(L):
        occluded = (keep & (pair_d[:, :, j] <= cand_d[:, j:j + 1])).any(dim=1)
        ok = valid[:, j] & ~occluded & (count < max_keep)
        keep[:, j] = ok
        count += ok.to(torch.int32)
    return keep


def gd_prune(base: torch.Tensor, graph: KnnGraph, max_keep: int | None = None,
             metric: str = "l2", chunk: int = GD_BLOCK) -> torch.Tensor:
    """HNSW-heuristic pruning of a flat graph; returns (n, L) ids, -1 padded,
    with at most ``max_keep`` (default L/2, per the paper) kept per vertex,
    compacted to the front in distance order."""
    from ..kernels import ops

    n, L = graph.neighbors.shape
    if max_keep is None:
        max_keep = L // 2
    dists, ids = sort_by_distance(graph.dists, graph.neighbors)
    base = base.float().contiguous()
    keep = torch.empty((n, L), dtype=torch.bool, device=ids.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        tids = ids[lo:hi]
        rows = base[tids.clamp(min=0).long()]                    # (B, L, d)
        pair_d = ops.distance_matrix(rows, rows, metric=metric)  # (B, L, L)
        bad = (tids < 0)[:, :, None] | (tids < 0)[:, None, :]
        pair_d = pair_d.masked_fill(bad, float("inf"))
        keep[lo:hi] = _occlusion_select(dists[lo:hi], pair_d, tids >= 0, max_keep)
    kept_ids = torch.where(keep, ids, torch.full_like(ids, INVALID))
    # compact kept entries to the front (they are distance-sorted already)
    _, order = torch.sort((~keep).to(torch.int8), dim=1, stable=True)
    return kept_ids.gather(1, order)


def build_gd_graph(base: torch.Tensor, graph: KnnGraph, metric: str = "l2",
                   max_keep: int | None = None,
                   max_degree: int | None = None) -> KnnGraph:
    """The paper's hybrid scheme: GD prune + reverse-edge union (KGraph+GD)."""
    L = graph.degree
    kept = gd_prune(base, graph, max_keep=max_keep, metric=metric)
    merged = add_reverse_edges(kept, max_degree or L)
    return KnnGraph(neighbors=merged,
                    dists=torch.full(merged.shape, float("nan"), device=merged.device))
