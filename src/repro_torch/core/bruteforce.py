"""Exact nearest-neighbor search — the paper's ground truth and speedup
denominator.

Chunked over the base so the (q, n) score matrix never materializes: each
chunk is one ``ops.distance_matrix`` call (the CUDA kernel on the card), and
a running top-k is merged outside the kernel with stable sorts.
"""
from __future__ import annotations

import torch

from .graph_index import KnnGraph
from .topk import INVALID, merge_candidates, topk_smallest


def exact_search(queries: torch.Tensor, base: torch.Tensor, k: int,
                 metric: str = "l2", chunk: int = 16384):
    """(q, d) vs (n, d) -> (dists (q, k), ids (q, k)) ascending; exact.

    Scans the base in ``chunk``-row tiles keeping a running top-k, so peak
    memory is O(q * chunk) rather than O(q * n). Ties keep the lower id."""
    from ..kernels import ops

    n = base.shape[0]
    chunk = min(chunk, n)
    q = queries.shape[0]
    dev = queries.device
    queries = queries.float().contiguous()
    best_d = torch.full((q, k), float("inf"), device=dev)
    best_i = torch.full((q, k), INVALID, dtype=torch.int32, device=dev)
    for lo in range(0, n, chunk):
        tile = base[lo:lo + chunk].float().contiguous()
        dmat = ops.distance_matrix(queries, tile, metric=metric)   # (q, c)
        cd, ci = topk_smallest(dmat, min(k, tile.shape[0]))
        ci = (ci + lo).to(torch.int32)
        ci = torch.where(cd < float("inf"), ci, torch.full_like(ci, INVALID))
        best_d, best_i = merge_candidates(best_d, best_i, cd, ci, k, dedup=False)
    return best_d, best_i


def ground_truth(queries: torch.Tensor, base: torch.Tensor, k: int,
                 metric: str = "l2") -> torch.Tensor:
    """Exact top-k ids (q, k) — used for recall@k across all experiments."""
    _, ids = exact_search(queries, base, k, metric)
    return ids


def exact_knn_graph(base: torch.Tensor, k: int, metric: str = "l2",
                    chunk: int = 4096) -> KnnGraph:
    """Exact k-NN graph (excluding self) — oracle for NN-Descent tests.
    Query rows are scanned ``chunk`` at a time."""
    n = base.shape[0]
    ds, ids = [], []
    for lo in range(0, n, chunk):
        d, i = exact_search(base[lo:lo + chunk], base, k + 1, metric)
        rows = torch.arange(lo, lo + i.shape[0], device=base.device)[:, None]
        self_mask = i == rows
        d = d.masked_fill(self_mask, float("inf"))
        i = i.masked_fill(self_mask, INVALID)
        d, order = torch.sort(d, dim=-1, stable=True)
        ds.append(d[:, :k])
        ids.append(i.gather(-1, order)[:, :k])
    return KnnGraph(neighbors=torch.cat(ids), dists=torch.cat(ds))
