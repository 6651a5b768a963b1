"""Search engine: (entry strategy x graph x beam core).

One beam core (``beam_search``), one flat adjacency, and a registry of
entry strategies that only decide where the beam starts, as the
reference's (``src/repro/core/engine.py``):

* ``random``     — E uniform seeds (the paper's flat-HNSW control),
* ``projection`` — E nearest in a tiny random projection (an SRS-style scan),
* ``hierarchy``  — HNSW's greedy descent reduced to a 1-seed picker,
* ``lsh``        — the SRS probe + exact rerank of ``baselines/lsh.py``,
* ``hubs``       — the top in-degree vertices, scored exactly, the nearest
                   taken.

Seed-phase comparisons are charged to ``SearchResult.n_comps`` in the
paper's currency, as the reference charges them. The port has the
``exact``, ``sq8`` and ``pq`` scorers, ``term="fixed"`` and ``"stable"``,
restarts, the three base placements (``core.base_store``: the float base on
the device, in host memory or in mmap'd shards, the last two traversing on
the compressed table and reranking from the tier) and filters
(``core.filters``: a metadata predicate compiled into a deny bitmap, or an
exact scan of the allowed ids where the filter is too selective to
traverse). ``Searcher.base`` stays on the device under every placement, as
the reference's does.

The shard helpers at the end (``globalize_ids``, ``merge_shard_results``,
``shard_entries``, ``shard_search``, ``shard_traverse``,
``emulated_shard_search``) run this engine's beam per shard for
``distributed.sharded_ann``: the reference's ``shard_map`` bodies become
per-rank calls over a ``torch.distributed`` group, their ``all_gather`` /
``psum`` the group's ``all_gather_single`` / ``all_reduce``.

Seeding draws from ``torch.Generator``s seeded from ints (the Searcher's
``rng_seed``, or a per-call ``seed``), not from ``jax.random`` keys, so
random entries, projections and restart draws differ from the
reference's. ``search(entries=...)`` takes precomputed entries, which is
how the tests inject the reference's draws. HNSW's descent runs its
per-layer loop on the host, one device sync a step (as the beam does);
``DESCENT_STEPS`` counts its descents and steps.
"""
from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import NamedTuple, Protocol

import torch
import torch.distributed as dist

from .base_store import BaseStore, StagedRows, check_placement, rerank_gathered
from .beam_search import (
    SearchResult,
    TraverseResult,
    beam_search,
    beam_traverse,
    dedup_rows,
    projection_entries,
    random_entries,
    rerank_slice,
    search_with_trace,
)
from .filters import CompiledFilter, FilterSpec, compile_filter, remap_denied_seeds
from .graph_index import HnswIndex, KnnGraph
from ..tracing import span
from .scorers import get_scorer
from .topk import INF, INVALID, topk_smallest


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
    base_placement: str = "device"  # where the float base lives: "device",
                                # "host" (host memory) or "disk" (mmap'd
                                # shards); the last two need pq or sq8
    store_dtype: str = "f32"    # the host/disk tier's row width: "f32"
                                # (bit-identical to device) or "bf16"
    hub_count: int = 32         # hubs scanned per query by the hubs seeder
    term: str = "fixed"         # "fixed" (classic rule) or "stable" (also
                                # freeze a row whose top-k stalls)
    stable_steps: int = 8       # the "stable" freeze's patience, in steps
    restarts: int = 0           # fresh-seed restarts per converged row
    restart_gate: float = 0.0   # restart only rows still > gate * seed best
    filter: FilterSpec | None = None  # metadata predicate / tenant namespace

    @property
    def num_seeds(self) -> int:
        return min(self.n_entries, self.ef)


# HNSW descents run and their loop steps, summed over layers (read and
# reset by chip_smoke.py)
DESCENT_STEPS = {"descents": 0, "steps": 0}


class _HostPending(NamedTuple):
    """A host- or disk-tier search in flight: traversal done, the survivor
    rows on their way to the device. ``Searcher._host_finish`` turns it
    into a :class:`SearchResult`; ``search_stream`` holds one while the
    next tile traverses."""

    spec: SearchSpec
    queries: torch.Tensor
    trav: TraverseResult
    cand: torch.Tensor         # (Q, r) survivor slice the rerank scores
    staged: StagedRows         # its rows and tier traffic, in flight
    scorer_state: object
    entry_comps: torch.Tensor | None
    d: int


class EntryStrategy(Protocol):
    """Pluggable seed picker. ``prepare`` builds the strategy's per-index
    state (projections, the layered index, the hub list) from an int seed;
    ``seed`` maps a query batch to ((Q, E) entry ids, (Q,) seed-phase
    comparisons), drawing from ``generator`` where it draws."""

    name: str

    def prepare(self, base, neighbors, hierarchy, spec: SearchSpec, seed: int): ...

    def seed(self, aux, queries, base, spec: SearchSpec, generator: torch.Generator): ...


ENTRY_STRATEGIES: dict[str, EntryStrategy] = {}


def get_entry_strategy(name: str) -> EntryStrategy:
    if name not in ENTRY_STRATEGIES:
        raise ValueError(f"unknown entry strategy {name!r}; registered: "
                         f"{sorted(ENTRY_STRATEGIES)}")
    return ENTRY_STRATEGIES[name]


def register_entry_strategy(strategy) -> EntryStrategy:
    """Register a seeder under ``strategy.name`` (a class, instantiated with
    no arguments, or an instance)."""
    inst = strategy() if isinstance(strategy, type) else strategy
    ENTRY_STRATEGIES[inst.name] = inst
    return strategy


@register_entry_strategy
class _RandomEntry:
    name = "random"

    def prepare(self, base, neighbors, hierarchy, spec, seed):
        return base.shape[0]

    def seed(self, aux, queries, base, spec, generator):
        Q = queries.shape[0]
        ent = random_entries(generator, aux, Q, spec.num_seeds)
        return ent, torch.zeros((Q,), dtype=torch.int32, device=queries.device)


def _srs(base, spec, seed):
    from ..baselines.lsh import build_srs

    return build_srs(base, m=spec.proj_dim,
                     generator=torch.Generator(device=base.device).manual_seed(seed))


@register_entry_strategy
class _ProjectionEntry:
    name = "projection"

    def prepare(self, base, neighbors, hierarchy, spec, seed):
        return _srs(base, spec, seed)

    def seed(self, aux, queries, base, spec, generator):
        ent = projection_entries(queries, aux.base_proj, aux.proj, spec.num_seeds)
        n, m = aux.base_proj.shape
        scan = int(n * m / base.shape[1])  # an m-dim pass at m/d of a comparison
        return ent, torch.full((queries.shape[0],), scan, dtype=torch.int32,
                               device=queries.device)


@register_entry_strategy
class _HierarchyEntry:
    name = "hierarchy"

    def prepare(self, base, neighbors, hierarchy, spec, seed):
        if hierarchy is None:
            raise ValueError("entry='hierarchy' needs a Searcher built from an HnswIndex")
        return hierarchy

    def seed(self, aux, queries, base, spec, generator):
        return hierarchy_entries(queries, base, aux, spec.metric)


@register_entry_strategy
class _LshEntry:
    name = "lsh"

    def prepare(self, base, neighbors, hierarchy, spec, seed):
        return _srs(base, spec, seed)

    def seed(self, aux, queries, base, spec, generator):
        # SRS is l2-only (sketch and rerank); under another metric the seeds
        # are merely worse, the beam still scores with spec.metric
        from ..baselines.lsh import srs_search

        _, ids, comps = srs_search(queries, base, aux, k=spec.num_seeds,
                                   probes=spec.lsh_probes)
        return ids.to(torch.int32), comps


@register_entry_strategy
class _HubsEntry:
    name = "hubs"

    def prepare(self, base, neighbors, hierarchy, spec, seed):
        # engines without an attached hub list: hubs are a deterministic
        # function of the adjacency, so this equals what a build persists
        from .graph_index import hub_vertices

        return hub_vertices(neighbors, spec.hub_count)

    def prepare_ctx(self, searcher, spec, seed):
        """Reuse the build's hub list where it covers ``spec.hub_count`` (it
        is in-degree descending, so its prefix is the top set)."""
        hubs = searcher.hubs
        if hubs is not None and hubs.shape[0] >= spec.hub_count:
            return hubs[:spec.hub_count].to(device=searcher.device,
                                            dtype=torch.int32).contiguous()
        return self.prepare(searcher.base, searcher.neighbors, searcher.hierarchy,
                            spec, seed)

    def seed(self, aux, queries, base, spec, generator):
        # an exact scan of the hub shortlist: H full comparisons a query
        from ..kernels import ops

        Q = queries.shape[0]
        H = aux.shape[0]
        ids = aux[None, :].expand(Q, H).contiguous()
        d = ops.gather_distance(queries, ids, base, metric=spec.metric)
        _, sel = topk_smallest(d, min(spec.num_seeds, H))
        ent = ids.gather(1, sel)
        return ent.to(torch.int32), torch.full((Q,), H, dtype=torch.int32,
                                               device=queries.device)


def _greedy_layer(queries, base, nbrs_g, slot, start_ids, metric):
    """Greedy 1-NN descent on one layer (the coarse-to-fine step, Fig. 1):
    start_ids (Q,) -> (ids (Q,), dists (Q,), comps (Q,), loop steps). Each
    step scores every unfinished row's layer neighbors (a finished row's
    are INVALID) and moves to the nearest where it is nearer; the loop
    reads ``done.all()`` once a step."""
    from ..kernels import ops

    Q = queries.shape[0]
    dev = queries.device
    cur = start_ids
    cur_d = ops.gather_distance(queries, cur[:, None].contiguous(), base, metric=metric)[:, 0]
    comps = torch.ones((Q,), dtype=torch.int32, device=dev)
    done = torch.zeros((Q,), dtype=torch.bool, device=dev)
    steps = 0
    while not bool(done.all()):
        rows = nbrs_g[slot[cur.clamp(min=0).long()].clamp(min=0).long()]   # (Q, M)
        rows = torch.where(done[:, None], torch.full_like(rows, INVALID), rows)
        nd = ops.gather_distance(queries, rows.contiguous(), base, metric=metric)
        comps = comps + (rows >= 0).sum(dim=1, dtype=torch.int32)
        j = torch.argmin(nd, dim=1, keepdim=True)      # the first minimum, as jnp.argmin
        best_d = nd.gather(1, j)[:, 0]
        best_i = rows.gather(1, j)[:, 0]
        better = best_d < cur_d
        cur = torch.where(better, best_i, cur)
        cur_d = torch.where(better, best_d, cur_d)
        done = done | ~better
        steps += 1
    return cur, cur_d, comps, steps


def hierarchy_entries(queries: torch.Tensor, base: torch.Tensor, index: HnswIndex,
                      metric: str) -> tuple[torch.Tensor, torch.Tensor]:
    """HNSW's upper layers as a seed picker: greedy descent from the top
    entry point down to layer 1, returning the (Q, 1) landing vertex and the
    comparisons spent."""
    Q = queries.shape[0]
    cur = torch.full((Q,), int(index.entry_point), dtype=torch.int32, device=queries.device)
    comps = torch.zeros((Q,), dtype=torch.int32, device=queries.device)
    for layer in range(index.num_layers - 1, 0, -1):
        cur, _, c, steps = _greedy_layer(queries, base, index.layers_neighbors[layer],
                                         index.layers_slot[layer], cur, metric)
        comps = comps + c
        DESCENT_STEPS["steps"] += steps
    DESCENT_STEPS["descents"] += 1
    return cur[:, None], comps


def filtered_brute_cutoff(spec: SearchSpec) -> int:
    """Allowed-set size at or below which a filtered search scans the
    allowed ids exactly instead of walking the graph (the reference's
    policy): masking hides denied ids but cannot make the allowed subgraph
    connected, and near ``ef`` allowed ids an exact scan is both cheaper
    and recall 1.0."""
    return max(4 * spec.ef, 192)


def _fold(seed: int, i: int) -> int:
    """A deterministic per-tile seed derived from (seed, i)."""
    return (seed * 0x9E3779B1 + 0x632BE5AB * (i + 1)) % (2**63 - 1)


# the stream the restart keys draw from: (seed, RESTART_STREAM)
RESTART_STREAM = 0x5EED

# rows per block of the pq scorer's per-query state (the OPQ rotation and
# the ADC LUTs): both are library products, which sum in another order at
# another row count (MKL's one-row path on the CPU; the batched product on
# an H100 too), so they run on zero-padded blocks of this many rows and a
# row's bits never depend on its batch's size. A request padded into a
# serving bucket gets the tables a direct search of its rows gets.
SCORER_BLOCK = 16


def _row_blocked(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` over ``x``'s rows in zero-padded SCORER_BLOCK-row blocks,
    concatenated and cut back to ``x``'s rows."""
    Q = x.shape[0]
    if Q == 0:
        return fn(x)
    out = []
    for lo in range(0, Q, SCORER_BLOCK):
        blk = x[lo:lo + SCORER_BLOCK]
        take = blk.shape[0]
        if take < SCORER_BLOCK:
            blk = torch.cat([blk, blk.new_zeros((SCORER_BLOCK - take,) + blk.shape[1:])])
        out.append(fn(blk)[:take])
    return out[0] if len(out) == 1 else torch.cat(out)


class Searcher:
    """(entry strategy x graph x beam core), bound to one dataset: the base
    (n, d) float32 and the flat adjacency (n, R) int32, on one device, and
    optionally an :class:`HnswIndex` whose upper layers back the
    ``hierarchy`` seeder and the build's hub list backing ``hubs``. Also
    bound per index: metadata columns for filters, with one
    :class:`~repro_torch.core.filters.CompiledFilter` cached per
    :class:`FilterSpec` in a bounded LRU, and a
    :class:`~repro_torch.core.base_store.BaseStore` per (placement,
    dtype)."""

    def __init__(self, base: torch.Tensor, neighbors: torch.Tensor, *,
                 hierarchy: HnswIndex | None = None, metric: str = "l2",
                 rng_seed: int = 0, pq=None, hubs: torch.Tensor | None = None,
                 tombstones: torch.Tensor | None = None,
                 metadata: dict | None = None):
        if base.device != neighbors.device:
            raise ValueError(f"base on {base.device} but neighbors on "
                             f"{neighbors.device}")
        self.base = base.float().contiguous()
        self.neighbors = neighbors.to(torch.int32).contiguous()
        self.hierarchy = hierarchy
        self.metric = metric
        self.rng_seed = rng_seed
        # top in-degree vertices, in-degree descending (None: the hubs
        # seeder recomputes them from the adjacency)
        self.hubs = hubs
        # (ceil(n/32),) int32 words marking deleted/unallocated ids
        self.tombstones = tombstones
        # the persisted PRNG key (uint32 payload, impl tag) of a loaded
        # artifact, written back unchanged on save (core.io); None writes
        # PRNGKey(rng_seed)'s payload
        self.key = None
        # metadata columns ((n,) numpy arrays: "tenant", "tag",
        # "timestamp", ...) that SearchSpec.filter predicates read
        self.metadata = metadata
        # CompiledFilter LRU keyed by FilterSpec; filter_compiles counts
        # compiles (an evicted filter compiles again on return)
        self._filters: OrderedDict[FilterSpec, CompiledFilter] = OrderedDict()
        self.filter_cache_size = 64
        self.filter_compiles = 0
        # BaseStore per (placement, dtype): "host" is a one-time host copy of
        # the base, "disk" a one-time spill to mmap'd temporary shards, or an
        # artifact's shards through attach_store
        self._stores: dict[tuple, BaseStore] = {}
        self.build_report = None
        # per-strategy prepared state, keyed by (entry, proj_dim, hub_count)
        self._aux: dict[tuple, object] = {}
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
    def from_hnsw(cls, base, index: HnswIndex, **kw) -> "Searcher":
        """The bottom layer becomes the flat graph; the upper layers feed the
        ``hierarchy`` seeder, so every entry strategy walks the same graph
        (the paper's controlled comparison)."""
        return cls(base, index.layers_neighbors[0], hierarchy=index, **kw)

    @classmethod
    def from_build(cls, base, result, *, metric: str | None = None,
                   rng_seed: int = 0) -> "Searcher":
        """Bind a :class:`~repro_torch.core.build.BuildResult` to an engine:
        the flat graph feeds the beam, the hierarchy (if built) backs the
        ``hierarchy`` seeder, the build's hub list the ``hubs`` seeder, and a
        build-time PQ table is attached. The report rides along as
        ``searcher.build_report``."""
        if metric is None:
            metric = result.report.spec.metric
        kw = dict(metric=metric, rng_seed=rng_seed, pq=result.pq, hubs=result.hubs)
        if result.hierarchy is not None:
            searcher = cls.from_hnsw(base, result.hierarchy, **kw)
        else:
            searcher = cls.from_graph(base, result.graph, **kw)
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
        get_entry_strategy(spec.entry)   # an unknown name raises ValueError
        get_scorer(spec.scorer)          # likewise

    def prepare(self, spec: SearchSpec):
        """Build (or fetch) the entry strategy's per-index state, from a seed
        derived from the searcher's ``rng_seed`` and the strategy's name.
        Strategies with ``prepare_ctx`` get the whole searcher."""
        strat = get_entry_strategy(spec.entry)
        cache_key = (spec.entry, spec.proj_dim, spec.hub_count)
        if cache_key not in self._aux:
            seed = _fold(self.rng_seed, zlib.crc32(spec.entry.encode()) & 0x7FFFFFFF)
            if hasattr(strat, "prepare_ctx"):
                self._aux[cache_key] = strat.prepare_ctx(self, spec, seed)
            else:
                self._aux[cache_key] = strat.prepare(self.base, self.neighbors,
                                                     self.hierarchy, spec, seed)
        return self._aux[cache_key]

    def generator(self, seed: int | None = None) -> torch.Generator:
        """A generator on the index's device seeded with ``seed`` (default:
        the searcher's ``rng_seed``)."""
        return torch.Generator(device=self.device).manual_seed(
            self.rng_seed if seed is None else seed)

    def seed(self, queries, spec: SearchSpec, seed: int | None = None):
        """(Q, E) entry ids + (Q,) seed-phase comparisons."""
        self._check_spec(spec)
        strat = get_entry_strategy(spec.entry)
        aux = self.prepare(spec)
        return strat.seed(aux, queries, self.base, spec, self.generator(seed))

    def restart_keys(self, n_rows: int, spec: SearchSpec,
                     seed: int | None = None) -> torch.Tensor | None:
        """Per-row restart keys for ``spec.restarts > 0`` (None otherwise):
        (n_rows,) int64 on the index's device, drawn in order from a CPU
        ``torch.Generator`` seeded from (seed, RESTART_STREAM). Row i's key
        is the stream's i-th draw whatever n_rows is, so a batch padded into
        a larger tile restarts its rows as a direct search does."""
        if spec.restarts <= 0:
            return None
        seed = self.rng_seed if seed is None else seed
        gen = torch.Generator().manual_seed(_fold(seed, RESTART_STREAM))
        keys = torch.randint(0, 2**31 - 1, (n_rows,), generator=gen, dtype=torch.int64)
        return keys.to(self.device)

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
        (queries rotated first under an OPQ table), built in SCORER_BLOCK-row
        blocks."""
        if spec.scorer == "sq8":
            idx = self.sq8_index()
            return (idx.codes, idx.scale, idx.mn)
        if spec.scorer != "pq":
            return None
        from ..baselines.pq import build_adc_luts

        idx = self.pq_index(spec)

        def block_luts(q):
            q = q if idx.rotation is None else q @ idx.rotation
            return build_adc_luts(q, idx.codebooks, spec.metric)

        return (idx.codes, _row_blocked(block_luts, queries).contiguous())

    # -- filtering ------------------------------------------------------------

    def compiled_filter(self, fspec: FilterSpec) -> CompiledFilter:
        """``fspec`` evaluated against this index's metadata, cached per
        filter value in a ``filter_cache_size``-bounded LRU. Tombstoned rows
        are taken out of the allowed set at compile time."""
        cached = self._filters.get(fspec)
        if cached is not None:
            self._filters.move_to_end(fspec)
            return cached
        cf = compile_filter(fspec, self.metadata, self.neighbors.shape[0],
                            dead=self.tombstones, device=self.device)
        self.filter_compiles += 1
        self._filters[fspec] = cf
        while len(self._filters) > self.filter_cache_size:
            self._filters.popitem(last=False)
        return cf

    def _filtered_brute(self, queries, cf: CompiledFilter, spec: SearchSpec, *,
                        q_valid: torch.Tensor | None = None) -> SearchResult:
        """Exact scan of the allowed ids, for filters too selective to
        traverse: ``n_allowed`` exact comparisons a query against the device
        base, whatever ``spec.scorer`` and ``spec.base_placement`` say, and
        recall 1.0. ``allowed_ids`` is padded to a power of two, so filters
        of similar selectivity share a shape."""
        from ..kernels import ops

        Q = queries.shape[0]
        allowed = cf.allowed_ids
        if spec.k > allowed.shape[0]:  # k answers need a scan >= k wide
            allowed = torch.cat([allowed, allowed.new_full((spec.k - allowed.shape[0],),
                                                           INVALID)])
        ids = allowed[None, :].expand(Q, allowed.shape[0]).contiguous()
        d = ops.gather_distance(queries, ids, self.base, metric=spec.metric)
        dd, sel = topk_smallest(d, spec.k)
        out = ids.gather(1, sel)
        out = torch.where(torch.isfinite(dd), out, torch.full_like(out, INVALID))
        comps = torch.full((Q,), cf.n_allowed, dtype=torch.int32, device=queries.device)
        if q_valid is not None:  # padding rows answer (INVALID, +inf, 0)
            out = torch.where(q_valid[:, None], out, torch.full_like(out, INVALID))
            dd = torch.where(q_valid[:, None], dd, torch.full_like(dd, float("inf")))
            comps = torch.where(q_valid, comps, torch.zeros_like(comps))
        return SearchResult(ids=out, dists=dd, n_comps=comps,
                            n_steps=torch.tensor(0, dtype=torch.int32),
                            bytes_touched=comps * (4 * queries.shape[1]))

    def _filter_plan(self, spec: SearchSpec):
        """(CompiledFilter or None, whether to route to the exact scan)."""
        if spec.filter is None:
            return None, False
        cf = self.compiled_filter(spec.filter)
        return cf, cf.n_allowed <= filtered_brute_cutoff(spec)

    def _remap_entries(self, entries, cf: CompiledFilter | None, seed: int | None):
        """Denied seeds become draws from the allowed set, keyed on the row
        index (``filters.remap_denied_seeds``)."""
        if cf is None:
            return entries
        return remap_denied_seeds(entries, cf, self.rng_seed if seed is None else seed)

    # -- tiered base ----------------------------------------------------------

    def base_store(self, placement: str = "device", dtype: str = "f32") -> BaseStore:
        """The base behind (``placement``, ``dtype``), built once and cached
        (a disk store spills the base to mmap'd temporary shards on first
        use; :meth:`attach_store` adopts an artifact's shards instead)."""
        check_placement(placement)
        ck = (placement, dtype)
        if ck not in self._stores:
            self._stores[ck] = BaseStore(self.base, placement, dtype=dtype,
                                         device=self.device)
        return self._stores[ck]

    def attach_store(self, store: BaseStore) -> BaseStore:
        """Adopt a built store as this searcher's (placement, dtype) tier:
        ``attach_store(BaseStore.from_shards(*io.open_base_shards(path)))``
        reranks straight off an artifact's shard files."""
        if store.device != self.device:
            raise ValueError(f"store copies rows to {store.device} but the index is "
                             f"on {self.device}")
        self._stores[(store.placement, store.dtype)] = store
        return store

    def _check_tier(self, spec: SearchSpec) -> None:
        check_placement(spec.base_placement)
        if spec.base_placement == "device":
            return
        sc = get_scorer(spec.scorer)
        if getattr(sc, "needs_base", True) or not sc.needs_rerank:
            raise ValueError(
                f"base_placement={spec.base_placement!r} traverses "
                "device-resident compressed state and reranks from the "
                f"backing tier; scorer={spec.scorer!r} reads the float base "
                "per hop — use a base-free scorer ('pq', 'sq8')")

    def _host_start(self, queries, spec: SearchSpec, seed: int | None = None, *,
                    entries: torch.Tensor | None = None,
                    entry_comps: torch.Tensor | None = None,
                    q_valid: torch.Tensor | None = None,
                    cf: CompiledFilter | None = None) -> _HostPending:
        """The device half of a host- or disk-tier search: seed, traverse on
        the compressed table, and issue the copy of the top-``rerank``
        survivor rows. Returns the search in flight; :meth:`_host_finish`
        completes it."""
        self._check_spec(spec)
        self._check_tier(spec)
        store = self.base_store(spec.base_placement, spec.store_dtype)
        queries = queries.float().contiguous()
        if entries is None:
            entries, entry_comps = self.seed(queries, spec, seed)
        entries = self._remap_entries(entries, cf, seed)
        if q_valid is not None and entry_comps is not None:
            entry_comps = torch.where(q_valid, entry_comps, torch.zeros_like(entry_comps))
        state = self.scorer_state(queries, spec)
        trav = beam_traverse(
            queries, self.neighbors, entries,
            ef=spec.ef, metric=spec.metric, max_steps=spec.max_steps,
            expand_width=spec.expand_width, r_tile=spec.r_tile,
            scorer=spec.scorer, scorer_state=state, q_valid=q_valid,
            k=spec.k, term=spec.term, stable_steps=spec.stable_steps,
            restarts=spec.restarts, restart_gate=spec.restart_gate,
            restart_keys=self.restart_keys(queries.shape[0], spec, seed),
            tombstones=self.tombstones, deny=None if cf is None else cf.deny,
        )
        cand = trav.cand_ids[:, :rerank_slice(spec.ef, spec.k, spec.rerank)].contiguous()
        return _HostPending(spec=spec, queries=queries, trav=trav, cand=cand,
                            staged=store.gather_start(cand), scorer_state=state,
                            entry_comps=entry_comps, d=store.d)

    def _host_finish(self, p: _HostPending) -> SearchResult:
        """Exact rerank of the gathered tier rows: the same survivors,
        distances and comparison bill as the device tier's ``_finalize``,
        so every placement gives the same answers (f32 stores).
        ``bytes_touched`` is the scorer's scored bytes plus the tier's own
        bill for the rerank rows."""
        rows, tier_bytes = p.staged.wait()
        dd, ids = rerank_gathered(p.queries, p.cand, rows, k=p.spec.k,
                                  metric=p.spec.metric)
        sc = get_scorer(p.spec.scorer)
        n_comps = (sc.scale_comps(p.scorer_state, p.trav.n_comps, p.d)
                   + (p.cand >= 0).sum(dim=1, dtype=torch.int32))
        if p.entry_comps is not None:
            n_comps = n_comps + p.entry_comps
        return SearchResult(
            ids=ids, dists=dd, n_comps=n_comps, n_steps=p.trav.n_steps,
            bytes_touched=sc.scored_bytes(p.scorer_state, p.trav.n_comps, p.d) + tier_bytes)

    # -- search ---------------------------------------------------------------

    def search(self, queries: torch.Tensor, spec: SearchSpec,
               seed: int | None = None, *,
               entries: torch.Tensor | None = None,
               entry_comps: torch.Tensor | None = None,
               q_valid: torch.Tensor | None = None) -> SearchResult:
        """Seed (unless ``entries`` are given) + beam. ``q_valid`` (Q,) bool
        marks real rows of a padded batch: padding rows cost zero
        comparisons and return (INVALID, +inf, 0).

        ``spec.filter`` restricts answers to a metadata predicate: its deny
        bitmap ORs into the visited seeding, denied seeds are redrawn from
        the allowed set, and a filter selective past
        :func:`filtered_brute_cutoff` scans the allowed ids exactly instead
        (``entries``, ``scorer`` and ``base_placement`` are then ignored).
        ``spec.base_placement`` "host" or "disk" traverses on the compressed
        table and reranks from that tier. Under a torch profiler the call is
        the span ``search``, with ``search.entries`` and
        ``search.scorer_state`` before the beam's own (``core.beam_search``)."""
        with span("search"):
            self._check_spec(spec)
            queries = queries.float().contiguous()
            cf, brute = self._filter_plan(spec)
            if brute:
                return self._filtered_brute(queries, cf, spec, q_valid=q_valid)
            if spec.base_placement != "device":
                return self._host_finish(self._host_start(
                    queries, spec, seed, entries=entries, entry_comps=entry_comps,
                    q_valid=q_valid, cf=cf))
            with span("search.entries"):
                if entries is None:
                    entries, entry_comps = self.seed(queries, spec, seed)
                entries = self._remap_entries(entries, cf, seed)
                if q_valid is not None and entry_comps is not None:
                    entry_comps = torch.where(q_valid, entry_comps,
                                              torch.zeros_like(entry_comps))
            with span("search.scorer_state"):
                state = self.scorer_state(queries, spec)
            res = beam_search(
                queries, self.base, self.neighbors, entries,
                ef=spec.ef, k=spec.k, metric=spec.metric,
                max_steps=spec.max_steps, expand_width=spec.expand_width,
                r_tile=spec.r_tile, scorer=spec.scorer,
                scorer_state=state, rerank=spec.rerank,
                q_valid=q_valid, term=spec.term, stable_steps=spec.stable_steps,
                restarts=spec.restarts, restart_gate=spec.restart_gate,
                restart_keys=self.restart_keys(queries.shape[0], spec, seed),
                tombstones=self.tombstones, deny=None if cf is None else cf.deny,
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
        compressed scorer's table is trained or quantized once, and a
        filter compiled once, before the tiles.

        Under a host or disk placement the tiles pipeline against the tier's
        copies: tile i's survivor rows are copied while tile i+1 seeds and
        traverses, and only then is tile i reranked."""
        self._check_spec(spec)
        Q = queries.shape[0]
        if Q <= tile_q:
            return self.search(queries, spec, seed)
        seed = self.rng_seed if seed is None else seed
        self.prepare(spec)
        if spec.scorer == "pq":
            self.pq_index(spec)
        elif spec.scorer == "sq8":
            self.sq8_index()
        cf, brute = self._filter_plan(spec)
        # a filter routed to the exact scan ignores placement
        tiered = spec.base_placement != "device" and not brute
        ids, dists, comps, tbytes = [], [], [], []
        n_steps = 0
        pending: tuple[_HostPending, int] | None = None

        def collect(res: SearchResult, take: int) -> None:
            nonlocal n_steps
            ids.append(res.ids[:take])
            dists.append(res.dists[:take])
            comps.append(res.n_comps[:take])
            tbytes.append(res.bytes_touched[:take])
            n_steps += int(res.n_steps)

        for i, lo in enumerate(range(0, Q, tile_q)):
            tile = queries[lo:lo + tile_q]
            take = tile.shape[0]
            pad = tile_q - take
            if pad:
                tile = torch.cat([tile, tile.new_zeros((pad, tile.shape[1]))])
            valid = torch.arange(tile_q, device=tile.device) < take
            if tiered:
                p = self._host_start(tile, spec, _fold(seed, i), q_valid=valid, cf=cf)
                if pending is not None:  # the previous tile, its copy overlapped
                    collect(self._host_finish(pending[0]), pending[1])
                pending = (p, take)
                continue
            collect(self.search(tile, spec, _fold(seed, i), q_valid=valid), take)
        if pending is not None:
            collect(self._host_finish(pending[0]), pending[1])
        return SearchResult(
            ids=torch.cat(ids), dists=torch.cat(dists),
            n_comps=torch.cat(comps),
            n_steps=torch.tensor(n_steps, dtype=torch.int32),
            bytes_touched=torch.cat(tbytes),
        )

    def search_with_trace(self, queries: torch.Tensor, spec: SearchSpec,
                          seed: int | None = None, max_steps: int | None = None):
        """The Fig. 6 trace through the same seeding path: (result, best
        distance after each step (steps, Q), cumulative comparisons (steps,
        Q)), the seed phase's comparisons included. ``spec.max_steps``, when
        set, overrides ``max_steps``; when both are unset the core's
        default applies. Device placement only, and never on the exact-scan
        route of a filter."""
        self._check_spec(spec)
        if spec.base_placement != "device":
            raise ValueError("search_with_trace requires base_placement='device'")
        cf, brute = self._filter_plan(spec)
        if brute:
            raise ValueError(
                "search_with_trace traces the graph walk; this filter routes "
                f"to the exact-scan fallback (n_allowed <= {filtered_brute_cutoff(spec)})"
                " — loosen the filter or trace unfiltered")
        queries = queries.float().contiguous()
        ent, extra = self.seed(queries, spec, seed)
        ent = self._remap_entries(ent, cf, seed)
        if spec.max_steps is not None:
            max_steps = spec.max_steps
        res, td, tc = search_with_trace(
            queries, self.base, self.neighbors, ent,
            ef=spec.ef, k=spec.k, metric=spec.metric, max_steps=max_steps,
            expand_width=spec.expand_width, r_tile=spec.r_tile, scorer=spec.scorer,
            scorer_state=self.scorer_state(queries, spec), rerank=spec.rerank,
            term=spec.term, stable_steps=spec.stable_steps,
            restarts=spec.restarts, restart_gate=spec.restart_gate,
            restart_keys=self.restart_keys(queries.shape[0], spec, seed),
            tombstones=self.tombstones, deny=None if cf is None else cf.deny,
        )
        return res._replace(n_comps=res.n_comps + extra), td, tc + extra[None, :]


# -- shard-level plumbing (the distributed layer runs THIS engine per shard) --


def globalize_ids(ids: torch.Tensor, shard_id, per: int) -> torch.Tensor:
    """Local row ids -> global ids for contiguous shard ``shard_id``
    (INVALID kept)."""
    return torch.where(ids >= 0, ids + shard_id * per, torch.full_like(ids, INVALID))


def merge_shard_results(dists: torch.Tensor, ids: torch.Tensor,
                        k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, P*k) gathered per-shard answers -> the k global best, ascending.
    Ties go to the lowest column, as the reference's ``lax.top_k`` breaks
    them (a stable sort)."""
    md, sel = topk_smallest(dists, k)
    return md, ids.gather(1, sel)


def shard_entries(generator: torch.Generator, n_shards: int, Q: int, per: int,
                  E: int) -> torch.Tensor:
    """Random per-shard seeds, (n_shards, Q, E) int32 local ids drawn on the
    generator's device: the ``random`` strategy drawn once per shard (each
    shard's graph is its own id space). A repeat within a row becomes
    INVALID, as ``random_entries`` leaves it: the beam needs dup-free rows
    (the reference's draw keeps repeats)."""
    draw = torch.randint(0, per, (n_shards * Q, E), generator=generator,
                         device=generator.device, dtype=torch.int32)
    return dedup_rows(draw).reshape(n_shards, Q, E)


def _if_live(live, x: torch.Tensor, fill) -> torch.Tensor:
    """``x`` where the shard is live, else ``fill`` everywhere: a dead
    shard answers (+inf, INVALID) and costs no comparisons."""
    live = torch.as_tensor(live, dtype=torch.bool, device=x.device)
    return torch.where(live, x, torch.full_like(x, fill))


# the collective behind ``all_gather_into_tensor`` (deprecated in its favour
# where both exist)
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-gather every rank's (Q, m) block into (Q, P*m), rank-major
    within a row: the reference's ``all_gather`` + transpose + reshape."""
    P = dist.get_world_size(group)
    Q, m = x.shape
    out = x.new_empty((P * Q, m))
    _all_gather_single(out, x.contiguous(), group=group)
    return out.reshape(P, Q, m).transpose(0, 1).reshape(Q, P * m)


def gather_merge(dists: torch.Tensor, gids: torch.Tensor, k: int, group=None):
    """Every rank's (Q, k) answers in global ids -> the k global best, the
    same on every rank."""
    return merge_shard_results(gather_rows(dists, group), gather_rows(gids, group), k)


def shard_search(queries, base, neighbors, entries, live, *, spec: SearchSpec,
                 group, per: int, scorer_state=None, restart_keys=None, deny=None):
    """One rank's part of shard-and-merge: the SAME beam core as single-host
    search over this rank's shard (the global rows from ``rank * per``),
    then the merge across ``group`` (a ``torch.distributed`` group; None is
    the default one). ``live`` False drops a failed or straggling
    shard's contribution (degrades recall, never the query).
    ``scorer_state`` is this shard's operand for ``spec.scorer`` (e.g. its
    local PQ codes + the batch LUTs); the rerank inside ``beam_search`` runs
    against the local base, so merged distances are exact whatever the
    scorer. ``restart_keys`` (the same on every rank) and ``deny`` (THIS
    shard's packed filter words over its local ids; entries already
    filter-valid) reach the shard's beam unchanged.

    Returns the merged (dists (Q, k), global ids (Q, k)) and the live
    shards' summed comparisons (Q,), the same on every rank."""
    if spec.base_placement != "device":
        raise ValueError(
            "shard_search reranks in-shard against a device-resident base; "
            "for base_placement='host' use shard_traverse + the caller-side "
            "host rerank (distributed_search(base_placement='host'))"
        )
    res = beam_search(
        queries, base, neighbors, entries,
        ef=spec.ef, k=spec.k, metric=spec.metric,
        max_steps=spec.max_steps, expand_width=spec.expand_width,
        r_tile=spec.r_tile, scorer=spec.scorer, scorer_state=scorer_state,
        rerank=spec.rerank,
        term=spec.term, stable_steps=spec.stable_steps,
        restarts=spec.restarts, restart_gate=spec.restart_gate,
        restart_keys=restart_keys, deny=deny,
    )
    gids = globalize_ids(res.ids, dist.get_rank(group), per)
    md, mi = gather_merge(_if_live(live, res.dists, INF), _if_live(live, gids, INVALID),
                          spec.k, group)
    comps = _if_live(live, res.n_comps, 0)
    dist.all_reduce(comps, group=group)
    return md, mi, comps


def shard_traverse(queries, neighbors, entries, live, *, spec: SearchSpec,
                   group, per: int, r: int, scorer_state,
                   restart_keys=None, deny=None):
    """One rank's part of the host-tier distributed path: traverse on the
    shard's code table only (no float base operand), globalize the
    top-``r`` survivors and all-gather them; the exact rerank runs after,
    against the one host-resident base no shard could fit.

    Returns ((Q, P*r) global survivor ids, (Q,) summed RAW scored-id
    counts), the same on every rank; the caller scales the counts to the
    paper's currency once it knows the store's d."""
    trav = beam_traverse(
        queries, neighbors, entries,
        ef=spec.ef, metric=spec.metric, max_steps=spec.max_steps,
        expand_width=spec.expand_width, r_tile=spec.r_tile,
        scorer=spec.scorer, scorer_state=scorer_state,
        k=spec.k, term=spec.term, stable_steps=spec.stable_steps,
        restarts=spec.restarts, restart_gate=spec.restart_gate,
        restart_keys=restart_keys, deny=deny,
    )
    gids = globalize_ids(trav.cand_ids[:, :r], dist.get_rank(group), per)
    comps = _if_live(live, trav.n_comps, 0)
    dist.all_reduce(comps, group=group)
    return gather_rows(_if_live(live, gids, INVALID), group), comps


def emulated_shard_search(queries, base_shards, nbr_shards, entries, live,
                          spec: SearchSpec, scorer_states=None,
                          restart_keys=None, denies=None):
    """A host-side loop with :func:`shard_search`'s semantics, for runs where
    the logical shards outnumber the ranks: one shard after another through
    the same beam, then the same merge. ``base_shards`` / ``nbr_shards`` /
    ``entries`` are (P, ...) stacks (or lists), ``live`` (P,) bool;
    ``scorer_states`` (optional) a per-shard list of scorer operands,
    ``denies`` (optional) a per-shard list of packed filter words.

    Returns (dists (Q, k), global ids (Q, k)) as the reference's does, and
    the live shards' summed comparisons (Q,), which :func:`shard_search`
    also returns."""
    if spec.base_placement != "device":
        raise ValueError(
            "emulated_shard_search reranks in-shard against device-resident "
            "base shards; the host tier goes through "
            "distributed_search(base_placement='host')"
        )
    per = base_shards[0].shape[0]
    live = torch.as_tensor(live, dtype=torch.bool, device=queries.device)
    all_d, all_i = [], []
    comps = None
    for s in range(len(base_shards)):
        res = beam_search(
            queries, base_shards[s], nbr_shards[s], entries[s],
            ef=spec.ef, k=spec.k, metric=spec.metric,
            max_steps=spec.max_steps, expand_width=spec.expand_width,
            r_tile=spec.r_tile, scorer=spec.scorer,
            scorer_state=None if scorer_states is None else scorer_states[s],
            rerank=spec.rerank,
            term=spec.term, stable_steps=spec.stable_steps,
            restarts=spec.restarts, restart_gate=spec.restart_gate,
            restart_keys=restart_keys,
            deny=None if denies is None else denies[s],
        )
        all_d.append(_if_live(live[s], res.dists, INF))
        all_i.append(_if_live(live[s], globalize_ids(res.ids, s, per), INVALID))
        c = _if_live(live[s], res.n_comps, 0)
        comps = c if comps is None else comps + c
    md, mi = merge_shard_results(torch.cat(all_d, 1), torch.cat(all_i, 1), spec.k)
    return md, mi, comps
