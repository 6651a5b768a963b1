"""Plain brute-force k nearest neighbours under squared L2.

A candidate pass scores every base row with the expanded form
``|q|^2 - 2 q.x + |x|^2`` in float32 (TF32 off, unless a caller asks for
it: the precision control does), one base block at a time, and keeps each
query's ``pool`` best. A refine pass recomputes those candidates' distances
in float64 in difference form and sorts them, so the answer's order and its
distances are float64's. With ``pool`` well above k, a true neighbour lost by
the candidate pass's rounding would need a float32 error larger than the gap
between rank k and rank ``pool``.
"""
from __future__ import annotations

import contextlib

import torch

BASE_BLOCK = 1 << 16
QUERY_BLOCK = 4096


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for float32 matrix products on or off inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def expanded_sq_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(m, d) x (b, d) -> (m, b) squared L2 in float32, expanded form."""
    qq = (q * q).sum(1, keepdim=True)
    xx = (x * x).sum(1)[None, :]
    return (qq - 2.0 * (q @ x.T) + xx).clamp_(min=0.0)


def sq_l2_f64(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """q (m, d) against rows (m, r, d) -> (m, r) squared L2 in float64,
    difference form."""
    diff = rows.double() - q.double()[:, None, :]
    return (diff * diff).sum(-1)


def candidates(queries: torch.Tensor, base: torch.Tensor, pool: int,
               allow_tf32: bool = False, exclude: torch.Tensor | None = None):
    """Each query's ``pool`` best base rows by the float32 expanded form:
    (dists (m, pool) float32 ascending, ids (m, pool) int64). ``exclude``
    (m,) ids are left out (a vertex's own row)."""
    m = queries.shape[0]
    best_d = torch.full((m, 0), float("inf"), device=queries.device)
    best_i = torch.zeros((m, 0), dtype=torch.int64, device=queries.device)
    with tf32(allow_tf32):
        for lo in range(0, base.shape[0], BASE_BLOCK):
            blk = base[lo:lo + BASE_BLOCK]
            dm = expanded_sq_l2(queries, blk)
            if exclude is not None:
                own = (exclude - lo)
                hit = (own >= 0) & (own < blk.shape[0])
                rows = torch.nonzero(hit).squeeze(1)
                dm[rows, own[rows]] = float("inf")
            d, i = torch.topk(dm, min(pool, blk.shape[0]), dim=1, largest=False)
            best_d = torch.cat([best_d, d], 1)
            best_i = torch.cat([best_i, i + lo], 1)
            if best_d.shape[1] > pool:
                best_d, j = torch.topk(best_d, pool, dim=1, largest=False)
                best_i = best_i.gather(1, j)
    order = torch.argsort(best_d, dim=1, stable=True)
    return best_d.gather(1, order), best_i.gather(1, order)


def exact_knn(queries: torch.Tensor, base: torch.Tensor, k: int, pool: int | None = None,
              exclude: torch.Tensor | None = None):
    """Exact k nearest base rows of each query: (dists (m, k) float64
    ascending, ids (m, k) int64), in query blocks of QUERY_BLOCK rows."""
    pool = max(2 * k, k + 16) if pool is None else pool
    out_d, out_i = [], []
    for lo in range(0, queries.shape[0], QUERY_BLOCK):
        q = queries[lo:lo + QUERY_BLOCK]
        ex = None if exclude is None else exclude[lo:lo + QUERY_BLOCK]
        _, ids = candidates(q, base, pool, exclude=ex)
        d64 = sq_l2_f64(q, base[ids])
        d64, order = torch.sort(d64, dim=1, stable=True)
        out_d.append(d64[:, :k])
        out_i.append(ids.gather(1, order)[:, :k])
    return torch.cat(out_d), torch.cat(out_i)


def approx_knn(queries: torch.Tensor, base: torch.Tensor, k: int,
               exclude: torch.Tensor | None = None):
    """The candidate pass alone with TF32 on: (dists (m, k) float32 from
    the expanded form, ids (m, k) int64). The precision control's search."""
    out_d, out_i = [], []
    for lo in range(0, queries.shape[0], QUERY_BLOCK):
        ex = None if exclude is None else exclude[lo:lo + QUERY_BLOCK]
        d, i = candidates(queries[lo:lo + QUERY_BLOCK], base, k, allow_tf32=True,
                          exclude=ex)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)
