"""Search engine: (entry strategy x graph x beam core).

One beam core (``beam_search``), one flat adjacency, and an entry strategy
that only decides where the beam starts. The port has the ``random``
entry, the ``exact``, ``sq8`` and ``pq`` scorers and the device-resident
base; any other ``entry``, ``scorer``, ``base_placement`` or ``filter``
raises ``NotImplementedError`` naming the roadmap item that ports it.

Seeding draws from ``torch.Generator``s seeded from ints (the Searcher's
``rng_seed``, or a per-call ``seed``), not from ``jax.random`` keys, so
random entries differ from the reference's. ``search(entries=...)`` takes
precomputed entries, which is how the tests inject the reference's draws.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .beam_search import SearchResult, beam_search, random_entries
from .graph_index import KnnGraph
from .scorers import get_scorer


class SearchSpec(NamedTuple):
    """Static search configuration (same fields and defaults as the
    reference's ``SearchSpec``)."""

    ef: int = 64                # candidate-list width of the beam core
    k: int = 1                  # answers returned per query
    metric: str = "l2"
    entry: str = "random"       # key into ENTRY_STRATEGIES
    n_entries: int = 8          # seeds handed to the beam (capped at ef)
    expand_width: int = 1       # vertices expanded per step
    max_steps: int | None = None
    proj_dim: int = 8           # sketch width for projection/lsh seeding
    lsh_probes: int = 64        # rerank candidates for the lsh seeder
    r_tile: int = 0             # gather-kernel neighbor tile (0 = default)
    scorer: str = "exact"       # key into SCORERS (per-hop distance impl)
    rerank: int = 0             # exact-reranked survivors (compressed only)
    pq_m: int = 8
    pq_k: int = 256
    pq_iters: int = 15
    base_placement: str = "device"  # where the float base lives
    store_dtype: str = "f32"
    hub_count: int = 32
    term: str = "fixed"         # beam termination: "fixed" (classic rule)
    stable_steps: int = 8
    restarts: int = 0
    restart_gate: float = 0.0
    filter: object | None = None

    @property
    def num_seeds(self) -> int:
        return min(self.n_entries, self.ef)


ENTRY_STRATEGIES = ("random",)  # the entry strategies this slice ports


def _fold(seed: int, i: int) -> int:
    """A deterministic per-tile seed derived from (seed, i)."""
    return (seed * 0x9E3779B1 + 0x632BE5AB * (i + 1)) % (2**63 - 1)


class Searcher:
    """(entry strategy x graph x beam core), bound to one dataset: the base
    (n, d) float32 and the flat adjacency (n, R) int32, on one device."""

    def __init__(self, base: torch.Tensor, neighbors: torch.Tensor, *,
                 metric: str = "l2", rng_seed: int = 0, pq=None,
                 tombstones: torch.Tensor | None = None):
        if base.device != neighbors.device:
            raise ValueError(f"base on {base.device} but neighbors on "
                             f"{neighbors.device}")
        self.base = base.float().contiguous()
        self.neighbors = neighbors.to(torch.int32).contiguous()
        self.metric = metric
        self.rng_seed = rng_seed
        # (ceil(n/32),) int32 words marking deleted/unallocated ids
        self.tombstones = tombstones
        self.build_report = None
        # PQ tables backing the "pq" scorer: one attached at build time
        # (served for any spec with its (M, K)), else trained lazily and
        # cached per (M, K, iters)
        self._pq_attached = pq
        self._pq: dict[tuple, object] = {}
        # the sq8 scorer's table, quantized once on first use
        self._sq8 = None

    @property
    def device(self) -> torch.device:
        return self.base.device

    # -- constructors ---------------------------------------------------------

    @classmethod
    def from_graph(cls, base, graph: KnnGraph, **kw) -> "Searcher":
        return cls(base, graph.neighbors, **kw)

    @classmethod
    def from_build(cls, base, result, *, metric: str | None = None,
                   rng_seed: int = 0) -> "Searcher":
        """Bind a :class:`~repro_torch.core.build.BuildResult` to an engine;
        the report rides along as ``searcher.build_report``."""
        if result.hierarchy is not None:
            raise NotImplementedError(
                "hierarchical indexes are not ported yet (ROADMAP.md, queue A item 8)")
        if metric is None:
            metric = result.report.spec.metric
        searcher = cls.from_graph(base, result.graph, metric=metric,
                                  rng_seed=rng_seed, pq=result.pq)
        searcher.build_report = result.report
        return searcher

    @classmethod
    def build(cls, base, *, metric: str = "l2", seed: int = 0,
              graph_k: int = 20, verbose: bool = False, spec=None) -> "Searcher":
        """Build the paper's hybrid index (NN-Descent + GD by default)
        through ``core.build`` on ``base``'s device."""
        from .build import BuildSpec, GraphBuilder

        if spec is None:
            spec = BuildSpec(metric=metric, graph_k=graph_k)
        result = GraphBuilder(spec).build(base, seed=seed, verbose=verbose)
        return cls.from_build(base, result, metric=spec.metric, rng_seed=seed)

    # -- seeding --------------------------------------------------------------

    def spec(self, **kw) -> SearchSpec:
        """SearchSpec pre-filled with this searcher's metric."""
        kw.setdefault("metric", self.metric)
        return SearchSpec(**kw)

    def _check_spec(self, spec: SearchSpec) -> None:
        if spec.metric != self.metric:
            raise ValueError(
                f"spec.metric={spec.metric!r} but this Searcher was built "
                f"for {self.metric!r}; use searcher.spec(...)"
            )
        if spec.entry not in ENTRY_STRATEGIES:
            raise NotImplementedError(
                f"entry strategy {spec.entry!r} is not ported yet (ported: "
                f"{list(ENTRY_STRATEGIES)}; ROADMAP.md, queue A item 8)")
        get_scorer(spec.scorer)  # an unknown name raises ValueError
        if spec.base_placement != "device":
            raise NotImplementedError(
                f"base_placement={spec.base_placement!r} is not ported yet "
                "(ROADMAP.md, queue A item 10)")
        if spec.filter is not None:
            raise NotImplementedError(
                "filtered search is not ported yet (ROADMAP.md, queue A item 11)")

    # -- scorers --------------------------------------------------------------

    @property
    def pq(self):
        """The PQ table this engine would serve without training: the
        attached build-time table, else the single lazily trained one, else
        None."""
        if self._pq_attached is not None:
            return self._pq_attached
        if len(self._pq) == 1:
            return next(iter(self._pq.values()))
        return None

    def pq_index(self, spec: SearchSpec):
        """The (spec.pq_m, spec.pq_k) PQ table: the attached one when it
        matches, else trained on first use from a seed derived from the
        searcher's ``rng_seed`` (a rebuilt engine reproduces it)."""
        from ..baselines.pq import build_pq, derive_pq_key

        a = self._pq_attached
        if a is not None and (a.M, a.K) == (spec.pq_m, spec.pq_k):
            return a
        cache_key = (spec.pq_m, spec.pq_k, spec.pq_iters)
        if cache_key not in self._pq:
            self._pq[cache_key] = build_pq(
                self.base, M=spec.pq_m, K=spec.pq_k, iters=spec.pq_iters,
                key=derive_pq_key(self.rng_seed))
        return self._pq[cache_key]

    def sq8_index(self):
        """The (codes, scale, mn) table backing the ``sq8`` scorer,
        quantized once per index."""
        if self._sq8 is None:
            from .scorers import build_sq8

            self._sq8 = build_sq8(self.base)
        return self._sq8

    def scorer_state(self, queries, spec: SearchSpec):
        """Per-batch operand of ``spec.scorer``: None for exact, the sq8
        table for sq8, and for pq the code table with per-query ADC LUTs
        (queries rotated first under an OPQ table)."""
        if spec.scorer == "sq8":
            idx = self.sq8_index()
            return (idx.codes, idx.scale, idx.mn)
        if spec.scorer != "pq":
            return None
        from ..baselines.pq import build_adc_luts

        idx = self.pq_index(spec)
        q = queries if idx.rotation is None else queries @ idx.rotation
        luts = build_adc_luts(q, idx.codebooks, spec.metric).contiguous()
        return (idx.codes, luts)

    def generator(self, seed: int | None = None) -> torch.Generator:
        """A generator on the index's device seeded with ``seed`` (default:
        the searcher's ``rng_seed``)."""
        return torch.Generator(device=self.device).manual_seed(
            self.rng_seed if seed is None else seed)

    def seed(self, queries, spec: SearchSpec, seed: int | None = None):
        """(Q, E) entry ids + (Q,) seed-phase comparisons."""
        self._check_spec(spec)
        Q = queries.shape[0]
        ent = random_entries(self.generator(seed), self.base.shape[0], Q,
                             spec.num_seeds)
        return ent, torch.zeros((Q,), dtype=torch.int32, device=queries.device)

    # -- search ---------------------------------------------------------------

    def search(self, queries: torch.Tensor, spec: SearchSpec,
               seed: int | None = None, *,
               entries: torch.Tensor | None = None,
               entry_comps: torch.Tensor | None = None,
               q_valid: torch.Tensor | None = None) -> SearchResult:
        """Seed (unless ``entries`` are given) + beam. ``q_valid`` (Q,) bool
        marks real rows of a padded batch: padding rows cost zero
        comparisons and return (INVALID, +inf, 0)."""
        self._check_spec(spec)
        queries = queries.float().contiguous()
        if entries is None:
            entries, entry_comps = self.seed(queries, spec, seed)
        if q_valid is not None and entry_comps is not None:
            entry_comps = torch.where(q_valid, entry_comps,
                                      torch.zeros_like(entry_comps))
        res = beam_search(
            queries, self.base, self.neighbors, entries,
            ef=spec.ef, k=spec.k, metric=spec.metric,
            max_steps=spec.max_steps, expand_width=spec.expand_width,
            r_tile=spec.r_tile, scorer=spec.scorer,
            scorer_state=self.scorer_state(queries, spec), rerank=spec.rerank,
            q_valid=q_valid, term=spec.term, stable_steps=spec.stable_steps,
            restarts=spec.restarts, restart_gate=spec.restart_gate,
            tombstones=self.tombstones,
        )
        if entry_comps is not None:
            res = res._replace(n_comps=res.n_comps + entry_comps)
        return res

    def search_stream(self, queries: torch.Tensor, spec: SearchSpec,
                      seed: int | None = None, *,
                      tile_q: int = 256) -> SearchResult:
        """Split a large Q into fixed ``tile_q``-row tiles (the last one
        padded and masked through ``q_valid``), each seeded from
        ``(seed, tile index)``. ``n_steps`` sums the tiles' loop steps. A
        compressed scorer's table is trained or quantized once, before the
        tiles."""
        self._check_spec(spec)
        Q = queries.shape[0]
        if Q <= tile_q:
            return self.search(queries, spec, seed)
        seed = self.rng_seed if seed is None else seed
        if spec.scorer == "pq":
            self.pq_index(spec)
        elif spec.scorer == "sq8":
            self.sq8_index()
        ids, dists, comps, tbytes = [], [], [], []
        n_steps = 0
        for i, lo in enumerate(range(0, Q, tile_q)):
            tile = queries[lo:lo + tile_q]
            take = tile.shape[0]
            pad = tile_q - take
            if pad:
                tile = torch.cat([tile, tile.new_zeros((pad, tile.shape[1]))])
            valid = torch.arange(tile_q, device=tile.device) < take
            res = self.search(tile, spec, _fold(seed, i), q_valid=valid)
            ids.append(res.ids[:take])
            dists.append(res.dists[:take])
            comps.append(res.n_comps[:take])
            tbytes.append(res.bytes_touched[:take])
            n_steps += int(res.n_steps)
        return SearchResult(
            ids=torch.cat(ids), dists=torch.cat(dists),
            n_comps=torch.cat(comps),
            n_steps=torch.tensor(n_steps, dtype=torch.int32),
            bytes_touched=torch.cat(tbytes),
        )
