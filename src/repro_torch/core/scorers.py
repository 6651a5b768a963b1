"""Pluggable scorer axis for the beam core.

``beam_search._step`` scores every neighbor expansion through one of these
objects. This slice ports the ``exact`` scorer (the fused float gather,
``ops.gather_distance_masked``: 4d bytes fetched and d MACs per scored
vertex, no rerank). The compressed ``sq8`` and ``pq`` scorers come with a
later slice of the port.

A scorer is (name, needs_rerank, needs_base, score, scale_comps,
scored_bytes); ``state`` is the per-batch operand the engine builds (None
for exact).
"""
from __future__ import annotations

from typing import Protocol


class Scorer(Protocol):
    name: str
    needs_rerank: bool
    # True when score() dereferences the float base per hop
    needs_base: bool

    def score(self, state, queries, base, ids, visited, *, metric: str,
              r_tile: int):
        """(Q, R) ids -> (dists (Q, R), masked ids (Q, R)) with the
        (+inf, INVALID) contract for padding/visited entries."""
        ...

    def scale_comps(self, state, n_comps, d: int):
        """Convert the loop's scored-id count into the paper's full-d
        comparison currency."""
        ...

    def scored_bytes(self, state, n_raw, d: int):
        """Bytes of base representation fetched for ``n_raw`` scored ids."""
        ...


SCORERS: dict[str, Scorer] = {}


def get_scorer(name: str) -> Scorer:
    if name not in SCORERS:
        raise ValueError(
            f"unknown scorer {name!r}; registered: {sorted(SCORERS)}"
        )
    return SCORERS[name]


def register_scorer(scorer) -> Scorer:
    """Register a scorer under ``scorer.name`` (class or instance)."""
    inst = scorer() if isinstance(scorer, type) else scorer
    SCORERS[inst.name] = inst
    return scorer


@register_scorer
class _ExactScorer:
    name = "exact"
    needs_rerank = False
    needs_base = True

    def score(self, state, queries, base, ids, visited, *, metric, r_tile):
        from ..kernels import ops

        return ops.gather_distance_masked(queries, ids, base, visited,
                                          metric=metric)

    def scale_comps(self, state, n_comps, d):
        return n_comps

    def scored_bytes(self, state, n_raw, d):
        return n_raw * (4 * d)
