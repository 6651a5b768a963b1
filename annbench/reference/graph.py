"""Plain pieces of the graph index the comparison needs.

``gd_keep``: a frozen copy of the paper's GD rule (HNSW's occlusion
heuristic, paper Fig. 2). Walking a vertex's candidates nearest first,
candidate c is kept unless some already kept s has d(s, c) <= d(v, c), and
at most ``max_keep`` are kept. It runs in float64 here; the precision
control runs it in float32 with TF32 products.

``bad_entries``: the adjacency's hard invariants, over every row: ids in
[-1, n), no self loop, no id twice in a row.
"""
from __future__ import annotations

import torch

from .knn import tf32

ROW_BLOCK = 1 << 18


def _pair_sq_l2(rows: torch.Tensor) -> torch.Tensor:
    """rows (S, L, d) -> (S, L, L) squared L2 between each vertex's
    candidates, expanded form in the rows' own precision."""
    sq = (rows * rows).sum(-1)
    return (sq[:, :, None] + sq[:, None, :]
            - 2.0 * torch.bmm(rows, rows.transpose(1, 2))).clamp_(min=0.0)


def gd_keep(vertex: torch.Tensor, cand_ids: torch.Tensor, base: torch.Tensor,
            max_keep: int, dtype=torch.float64, allow_tf32: bool = False) -> torch.Tensor:
    """GD's survivors: vertex (S, d), cand_ids (S, L) int64 ascending by
    distance to the vertex -> keep mask (S, L). Distances in ``dtype``
    (float64 for the reference; float32 with ``allow_tf32`` for the
    control)."""
    rows = base[cand_ids].to(dtype)                          # (S, L, d)
    v = vertex.to(dtype)
    with tf32(allow_tf32):
        if dtype == torch.float64:
            diff = rows - v[:, None, :]
            cand_d = (diff * diff).sum(-1)
        else:
            cand_d = ((v * v).sum(-1)[:, None] + (rows * rows).sum(-1)
                      - 2.0 * torch.bmm(rows, v[:, :, None]).squeeze(-1)).clamp_(min=0.0)
        pair = _pair_sq_l2(rows)
    S, L = cand_ids.shape
    keep = torch.zeros((S, L), dtype=torch.bool, device=cand_ids.device)
    count = torch.zeros((S,), dtype=torch.int64, device=cand_ids.device)
    for j in range(L):
        occluded = (keep & (pair[:, :, j] <= cand_d[:, j:j + 1])).any(dim=1)
        ok = ~occluded & (count < max_keep)
        keep[:, j] = ok
        count += ok.to(torch.int64)
    return keep


def bad_entries(neighbors: torch.Tensor, n: int, rows: torch.Tensor | None = None) -> int:
    """Entries that break the adjacency's invariants: an id outside [-1, n),
    a self loop, or a repeat of an id earlier in its row (sorted). ``rows``
    gives each row's own vertex id (default: its index)."""
    total = 0
    for lo in range(0, neighbors.shape[0], ROW_BLOCK):
        blk = neighbors[lo:lo + ROW_BLOCK].to(torch.int64)
        own = (torch.arange(lo, lo + blk.shape[0], device=blk.device) if rows is None
               else rows[lo:lo + ROW_BLOCK].to(torch.int64))
        out = (blk < -1) | (blk >= n)
        loop = blk == own[:, None]
        srt, _ = torch.sort(blk, dim=1)
        rep = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
        total += int(out.sum()) + int(loop.sum()) + int(rep.sum())
    return total
