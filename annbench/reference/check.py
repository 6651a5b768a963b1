"""The comparison that decides ``correct``: readings of the program's outputs
against the plain reference, and the precision control that stands in the
program's place.

Search answers (:class:`AnswerJudge`): every answer of every batch, judged
against the reference's exact neighbours of the same queries.

- ``bad_answers``: rows with an id outside [0, n), an id twice, a NaN, or
  distances out of ascending order. Exact: the limit is 0.
- ``dist_err``: the largest relative gap between a returned distance and the
  float64 squared L2 of the same (query, id), over every answer.
- ``recall_deficit``: 1 - recall@k against the exact top k, on the rows
  the caller samples (``recall_rows``).

Graph rows (:func:`judge_rows`), on vertices sampled from the seed:

- ``nn1_miss``: share of sampled vertices whose exact nearest neighbour is
  not among their out-edges.
- ``gd_keep_miss``: share of the edges that float64 GD keeps from a vertex's
  exact L nearest that are missing from its row.

``edge_dist_err`` (:func:`edge_dist_err`): the largest relative gap between
a distance the build's NN-Descent stage kept for an edge and the float64
squared L2 of the same pair, over the sampled vertices' rows. (The GD graph
a build returns carries no distances.)

``bad_entries`` (:func:`.graph.bad_entries`) holds every row of the graph to
its invariants. The precision control (:func:`control_answers`,
:func:`control_edges`, :func:`control_rows`) is the reference with its
products in TF32, the precision just below the configuration's float32 with
TF32 off; the guarantee control (``keep_self=True``) breaks the index's
stated "no self loop".
"""
from __future__ import annotations

import torch

from ..metrics._lib import recall_hits
from .graph import gd_keep
from .knn import approx_knn, exact_knn, sq_l2_f64

ANSWER_BLOCK = 8192


class AnswerJudge:
    """Accumulates the answer readings over batches (``add``) and returns
    them (``readings``)."""

    def __init__(self, base: torch.Tensor, k: int):
        self.base, self.k = base, k
        self.n = base.shape[0]
        self.rows = self.bad = self.hits = self.answered = 0
        self.dist_err = 0.0

    def add(self, queries: torch.Tensor, ids: torch.Tensor, dists: torch.Tensor,
            recall_rows: torch.Tensor | None = None) -> None:
        """Judge a batch's answers: every row for ``bad_answers`` and
        ``dist_err``; the rows ``recall_rows`` (all where None) against the
        exact neighbours for recall."""
        ids, dists = ids.long(), dists.float()
        for lo in range(0, queries.shape[0], ANSWER_BLOCK):
            self._block(queries[lo:lo + ANSWER_BLOCK], ids[lo:lo + ANSWER_BLOCK],
                        dists[lo:lo + ANSWER_BLOCK])
        rows = torch.arange(queries.shape[0], device=queries.device) if recall_rows is None \
            else recall_rows.to(queries.device)
        for lo in range(0, rows.shape[0], ANSWER_BLOCK):
            r = rows[lo:lo + ANSWER_BLOCK]
            _, truth = exact_knn(queries[r], self.base, self.k)
            self.hits += recall_hits(ids[r], truth)
            self.rows += r.shape[0]

    def _block(self, q, ids, dists) -> None:
        valid = (ids >= 0) & (ids < self.n)
        srt, _ = torch.sort(ids, dim=1)
        twice = (srt[:, 1:] == srt[:, :-1]).any(1)
        unordered = (dists[:, 1:] < dists[:, :-1]).any(1)
        bad = (~valid).any(1) | twice | torch.isnan(dists).any(1) | unordered
        self.bad += int(bad.sum())
        d64 = sq_l2_f64(q, self.base[ids.clamp(0, self.n - 1)])
        rel = (dists.double() - d64).abs() / d64.clamp(min=1e-12)
        rel = torch.where(valid, rel, torch.zeros_like(rel))
        self.dist_err = max(self.dist_err, float(rel.max()))
        self.answered += q.shape[0]

    def readings(self) -> dict:
        recall = self.hits / max(self.rows * self.k, 1)
        return {"bad_answers": self.bad, "dist_err": self.dist_err,
                "recall_deficit": 1.0 - recall, "recall_at_10": recall,
                "answered": self.answered, "recall_rows": self.rows}


def sample_vertices(n: int, count: int, seed: int, device) -> torch.Tensor:
    """``count`` distinct vertex ids drawn from ``seed`` (int64)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randperm(n, generator=gen, device=device)[:min(count, n)]


def judge_rows(base: torch.Tensor, vertices: torch.Tensor, rows: torch.Tensor,
               L: int, max_keep: int) -> dict:
    """Readings of sampled graph rows: ``rows`` (S, R) are the out-edges of
    ``vertices`` (S,), -1 padded."""
    rows = rows.long()
    vec = base[vertices]
    _, nn_u = exact_knn(vec, base, L, exclude=vertices)            # (S, L)
    valid = rows >= 0

    def present(ids):
        return ((ids[:, :, None] == rows[:, None, :]) & valid[:, None, :]).any(2)

    keep = gd_keep(vec, nn_u, base, max_keep)
    return {"nn1_miss": float((~present(nn_u[:, :1])).float().mean()),
            "gd_keep_miss": float((keep & ~present(nn_u)).sum()) / max(int(keep.sum()), 1)}


def edge_dist_err(base: torch.Tensor, vertices: torch.Tensor, ids: torch.Tensor,
                  dists: torch.Tensor) -> float:
    """Largest relative gap between the distances ``dists`` (S, L) a graph
    keeps for the edges ``ids`` (S, L) of ``vertices`` (S,) and their
    float64 squared L2; padding (id < 0) is left out, a NaN or an infinite
    distance on an edge reads infinite."""
    ids = ids.long()
    valid = ids >= 0
    d64 = sq_l2_f64(base[vertices], base[ids.clamp(min=0)])
    rel = (dists.double() - d64).abs() / d64.clamp(min=1e-12)
    rel = torch.where(torch.isfinite(rel), rel, torch.full_like(rel, float("inf")))
    rel = torch.where(valid, rel, torch.zeros_like(rel))
    return float(rel.max()) if rel.numel() else 0.0


def control_edges(base: torch.Tensor, vertices: torch.Tensor, L: int,
                  keep_self: bool = False):
    """The precision control's NN-Descent stage for ``vertices``: each
    vertex's L nearest with TF32 products -> (dists (S, L) float32, ids (S,
    L) int64). ``keep_self`` leaves the vertex among its own nearest."""
    return approx_knn(base[vertices], base, L, exclude=None if keep_self else vertices)


def control_answers(base: torch.Tensor, queries: torch.Tensor, k: int):
    """The precision control's search answers: brute force with TF32
    products -> (ids (m, k), dists (m, k) float32)."""
    d, i = approx_knn(queries, base, k)
    return i, d


def control_rows(base: torch.Tensor, vertices: torch.Tensor, L: int, max_keep: int,
                 keep_self: bool = False, cand: torch.Tensor | None = None):
    """The precision control's graph rows for ``vertices``: each vertex's L
    nearest (``cand``, or :func:`control_edges`'s) and GD's survivors among
    them, both with TF32 products (the kept forward edges, -1 padded).
    ``keep_self`` leaves the vertex among its own nearest: the guarantee
    control, which breaks the stated "no self loop"."""
    if cand is None:
        _, cand = control_edges(base, vertices, L, keep_self)
    keep = gd_keep(base[vertices], cand, base, max_keep, dtype=torch.float32,
                   allow_tf32=True)
    return torch.where(keep, cand, torch.full_like(cand, -1))
