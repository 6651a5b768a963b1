"""Pluggable scorer axis for the beam core.

``beam_search._step`` scores every neighbor expansion through one of these
objects, so the traversal can run on compressed representations while
``beam_search._finalize`` reranks the survivors exactly:

* ``exact`` — the fused float gather (``ops.gather_distance_masked``): 4d
  bytes fetched and d MACs per scored vertex. No rerank.
* ``sq8``   — scalar quantization (``ops.gather_sq8_masked``): the base as
  an (n, d) uint8 table with per-dimension affine dequant params, d bytes
  per scored vertex, full-rank geometry; comps charged at 1/4 per score.
* ``pq``    — PQ asymmetric distances (``ops.gather_adc_masked``): M bytes
  per scored vertex against per-query (M, K) LUTs built once per batch;
  comps charged at M/d per score.

A scorer is (name, needs_rerank, needs_base, score, scale_comps,
scored_bytes); ``state`` is the per-batch operand the engine builds
(``Searcher.scorer_state``): None for exact, (codes, scale, mn) for sq8,
(codes, luts) for pq.
"""
from __future__ import annotations

from typing import NamedTuple, Protocol

import torch


class Sq8Index(NamedTuple):
    """Scalar-quantized base: per-dimension affine uint8 codes.
    ``codes * scale + mn`` reconstructs the base to ~1/255 of each
    dimension's range. Deterministic (min/max over the base, no draws)."""

    codes: torch.Tensor   # (n, d) uint8
    scale: torch.Tensor   # (d,) float32 — (max - min) / 255, zero range -> 1
    mn: torch.Tensor      # (d,) float32 — per-dimension minimum


def build_sq8(base: torch.Tensor) -> Sq8Index:
    """Quantize an (n, d) float base to the sq8 scorer's state, on its
    device. ``torch.round`` rounds half to even, as ``jnp.round`` does, so
    the table is bit-identical to the reference's."""
    b = base.float()
    mn = b.min(dim=0).values
    rng = b.max(dim=0).values - mn
    scale = torch.where(rng > 0, rng / 255.0, torch.ones_like(rng))
    codes = torch.clamp(torch.round((b - mn) / scale), 0, 255).to(torch.uint8)
    return Sq8Index(codes=codes, scale=scale, mn=mn)


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


@register_scorer
class _Sq8Scorer:
    name = "sq8"
    needs_rerank = True
    needs_base = False  # scores the uint8 table from scorer_state

    def score(self, state, queries, base, ids, visited, *, metric, r_tile):
        from ..kernels import ops

        if state is None:
            raise ValueError(
                "scorer='sq8' needs a (codes, scale, mn) scorer_state — build "
                "it via Searcher.scorer_state / core.scorers.build_sq8")
        codes, scale, mn = state
        return ops.gather_sq8_masked(queries, ids, codes, scale, mn, visited,
                                     metric=metric)

    def scale_comps(self, state, n_comps, d):
        # d uint8 bytes fetched per scored vertex vs 4d float bytes exact
        return n_comps // 4

    def scored_bytes(self, state, n_raw, d):
        return n_raw * d


@register_scorer
class _PQScorer:
    name = "pq"
    needs_rerank = True
    needs_base = False  # ADC reads codes from scorer_state, never the base

    def score(self, state, queries, base, ids, visited, *, metric, r_tile):
        from ..kernels import ops

        if state is None:
            raise ValueError(
                "scorer='pq' needs a (codes, luts) scorer_state — build it via "
                "Searcher.scorer_state / baselines.pq.build_adc_luts")
        codes, luts = state
        return ops.gather_adc_masked(ids, codes, luts, visited)

    def scale_comps(self, state, n_comps, d):
        codes, _ = state
        return (n_comps * codes.shape[1]) // d

    def scored_bytes(self, state, n_raw, d):
        codes, _ = state
        return n_raw * codes.shape[1]
