"""Fixed-shape top-k / sorted-list utilities used across builders and search.

Conventions: candidate lists are kept sorted ascending by distance; the id
``INVALID`` (= -1) marks padding and always sorts last (distance = +inf).
Every selection is a stable sort, so ties break toward the lowest index as
``lax.top_k`` and the reference's stable argsorts do (``torch.topk``'s tie
order is unspecified).
"""
from __future__ import annotations

import torch

INVALID = -1
INF = float("inf")


def topk_smallest(dists: torch.Tensor, k: int):
    """(.., m) -> (values, indices) of the k smallest, ascending; ties go to
    the lowest index."""
    vals, idx = torch.sort(dists, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def sort_by_distance(dists: torch.Tensor, ids: torch.Tensor):
    """Sort (..., m) candidate lists ascending by distance (stable)."""
    vals, order = torch.sort(dists, dim=-1, stable=True)
    return vals, ids.gather(-1, order)


def dedup_by_id(dists: torch.Tensor, ids: torch.Tensor):
    """Mask duplicate ids per row (keep the smallest distance per id), then
    sort each row by distance. Works on (..., m) batches of lists.

    As in the reference: a stable sort by distance, then a stable sort by
    id, mark entries equal to their predecessor, set them (+inf, INVALID)."""
    dists_d, order_d = torch.sort(dists, dim=-1, stable=True)
    ids_d = ids.gather(-1, order_d)
    ids_s, order_i = torch.sort(ids_d, dim=-1, stable=True)
    dists_s = dists_d.gather(-1, order_i)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[..., 1:] = ids_s[..., 1:] == ids_s[..., :-1]
    dup |= ids_s == INVALID
    dists_s = dists_s.masked_fill(dup, INF)
    ids_s = ids_s.masked_fill(dup, INVALID)
    return sort_by_distance(dists_s, ids_s)


def merge_candidates(dists_a, ids_a, dists_b, ids_b, k: int, *, dedup: bool = True):
    """Merge two candidate lists (1-D, or batched along leading dims) into
    the k best, ascending, id-deduped unless ``dedup=False``."""
    dists = torch.cat([dists_a, dists_b], dim=-1)
    ids = torch.cat([ids_a, ids_b], dim=-1)
    if dedup:
        dists, ids = dedup_by_id(dists, ids)
    else:
        dists, ids = sort_by_distance(dists, ids)
    return dists[..., :k], ids[..., :k]


def recall_at_k(found_ids: torch.Tensor, true_ids: torch.Tensor) -> float:
    """Mean recall@k: fraction of true_ids (..., k) present in found_ids
    (..., k')."""
    hits = (found_ids[..., :, None] == true_ids[..., None, :]) & (
        true_ids[..., None, :] != INVALID
    )
    per_query = hits.any(dim=-2).sum(dim=-1).double() / true_ids.shape[-1]
    return float(per_query.mean())
