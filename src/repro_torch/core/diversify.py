"""Graph diversification — the paper's hybrid scheme (Sec. III/IV).

* **GD** (HNSW's occlusion heuristic, paper Fig. 2): keep candidate c iff
  d(v,c) < d(s,c) for every already-kept s; at most L/2 survivors; then union
  with reverse edges ("KGraph+GD").
* **DPG** [Li TKDE'19]: greedy max-min *angular* selection among the edge
  directions (c - v), L/2 survivors, then the full reverse union (DPG's
  index is ~2x GD's, as the paper notes).

Each vertex's candidate geometry is an (L, L) distance matrix; a block of
vertices is one batched ``ops.distance_matrix`` call (one kernel launch for
the whole block instead of one per vertex). The greedy selection is a Python
loop over the L candidate slots, vectorized across every vertex of the
block. DPG's (L, L) cosine similarities are one ``torch.bmm`` a block (the
reference computes them with ``jnp.einsum`` outside any kernel) and its
greedy selection a loop of ``max_keep - 1`` steps over the block's rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .graph_index import KnnGraph
from .topk import INVALID, sort_by_distance

GD_BLOCK = 1 << 16   # vertices whose (L, L) matrices one launch computes
DPG_BLOCK_BYTES = 1 << 30  # a DPG block's (B, L, max(d, L)) float32 operands

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


# -- DPG: angular diversification ---------------------------------------------


def _angular_select(cos_sim: torch.Tensor, valid: torch.Tensor,
                    max_keep: int) -> torch.Tensor:
    """Greedy max-min angular selection, vertices (B,): cos_sim (B, L, L)
    between edge directions (c_i - v), valid (B, L) -> keep mask (B, L).

    Seeded with the nearest valid candidate (candidates arrive
    distance-sorted); each of the ``max_keep - 1`` steps keeps the candidate
    whose largest similarity to the kept set is smallest (the first such on
    a tie, as ``jnp.argmin``)."""
    B, L = valid.shape
    rows = torch.arange(B, device=valid.device)
    seed = valid.to(torch.int8).argmax(dim=1)
    keep = torch.zeros((B, L), dtype=torch.bool, device=valid.device)
    keep[rows, seed] = valid[rows, seed]
    neg_inf = torch.tensor(float("-inf"), device=valid.device)
    inf = torch.tensor(float("inf"), device=valid.device)
    for _ in range(1, max_keep):
        sim_to_kept = torch.where(keep[:, None, :], cos_sim, neg_inf).amax(dim=2)
        score = torch.where(valid & ~keep, sim_to_kept, inf)
        j = score.argmin(dim=1)
        keep[rows, j] |= score[rows, j] < inf
    return keep


def dpg_keep(base: torch.Tensor, vertices: torch.Tensor, ids: torch.Tensor,
             max_keep: int) -> torch.Tensor:
    """DPG's keep mask (B, L) for ``vertices`` (B,) whose distance-sorted
    candidate ids are ``ids`` (B, L), INVALID padded."""
    v = base[vertices.long()]                                     # (B, d)
    e = base[ids.clamp(min=0).long()] - v[:, None, :]              # (B, L, d)
    e = e * torch.rsqrt(torch.clamp((e * e).sum(-1, keepdim=True), min=1e-12))
    cs = torch.bmm(e, e.transpose(1, 2))                           # (B, L, L)
    return _angular_select(cs, ids >= 0, max_keep)


def dpg_prune(base: torch.Tensor, graph: KnnGraph, max_keep: int | None = None,
              chunk: int | None = None) -> torch.Tensor:
    """DPG's angular pruning of a flat graph; returns (n, L) ids, -1 padded,
    at most ``max_keep`` (default L/2) kept per vertex, compacted to the
    front in distance order. ``chunk`` (vertices a block; default: as many
    as keep a block's operands within ``DPG_BLOCK_BYTES``) does not change
    the result."""
    n, L = graph.neighbors.shape
    if max_keep is None:
        max_keep = L // 2
    if chunk is None:
        chunk = max(512, DPG_BLOCK_BYTES // (4 * L * max(base.shape[1], L)))
    _, ids = sort_by_distance(graph.dists, graph.neighbors)
    base = base.float().contiguous()
    keep = torch.empty((n, L), dtype=torch.bool, device=ids.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        rows = torch.arange(lo, hi, device=ids.device)
        keep[lo:hi] = dpg_keep(base, rows, ids[lo:hi], max_keep)
    kept_ids = torch.where(keep, ids, torch.full_like(ids, INVALID))
    _, order = torch.sort((~keep).to(torch.int8), dim=1, stable=True)
    return kept_ids.gather(1, order)


def build_dpg_graph(base: torch.Tensor, graph: KnnGraph, max_keep: int | None = None,
                    max_degree: int | None = None) -> KnnGraph:
    """DPG = angular diversification + reverse edges [Li TKDE'19]; the
    union keeps up to 2x the kept degree by default."""
    L = graph.degree
    kept = dpg_prune(base, graph, max_keep=max_keep)
    merged = add_reverse_edges(kept, max_degree or 2 * (max_keep or L // 2))
    return KnnGraph(neighbors=merged,
                    dists=torch.full(merged.shape, float("nan"), device=merged.device))
