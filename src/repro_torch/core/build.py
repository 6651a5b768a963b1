"""Build pipeline — BuildSpec × (construct · diversify · compress).

The same composable stages as ``repro.core.build``: a construct stage makes
the raw neighborhood graph, a diversify stage selects its edges, a compress
stage trains codes for compressed scorers. The port registers the
``nndescent``, ``exact``, ``hnsw`` and ``incremental`` constructs, the
``none``, ``gd`` and ``dpg`` diversifiers and the ``none``, ``pq`` and
``opq`` compressors. ``hnsw`` prunes every layer itself, so it pairs with
``diversify="none"`` only. ``incremental`` inserts the points one by one
through ``core.mutable.MutableIndex`` and applies ``spec.diversify`` per
insert, so ``GraphBuilder`` skips its global diversify stage.

``GraphBuilder(spec).build(base, seed)`` runs on ``base``'s device and emits
a :class:`BuildReport` (rounds, update curve, realized degree distribution,
dropped reverse edges, graph-recall proxy, walls, memory; on a GPU also the
peak device memory of each stage).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import torch

from .graph_index import (
    DEFAULT_N_HUBS,
    KnnGraph,
    degree_distribution,
    hub_vertices,
    in_degree_distribution,
    memory_bytes,
    pad_neighbors,
)
from .topk import INVALID

REVERSE_POLICIES = ("union", "none")


class BuildSpec(NamedTuple):
    """Static build configuration (same fields and defaults as the
    reference; zero values of ``hnsw_m`` / ``max_keep`` / ``max_degree``
    mean "stage default")."""

    construct: str = "nndescent"   # key into CONSTRUCTORS
    diversify: str = "gd"          # key into DIVERSIFIERS
    compress: str = "none"         # key into COMPRESSORS
    metric: str = "l2"
    graph_k: int = 20              # raw k-NN degree out of the construct stage
    nd_rounds: int = 15            # NN-Descent round budget
    nd_delta: float = 0.002        # early-termination update-rate threshold
    hnsw_m: int = 0                # upper-layer degree (0 = max(8, graph_k/2))
    max_keep: int = 0              # survivors per vertex (0 = L/2, the paper)
    max_degree: int = 0            # post-union degree cap (0 = stage default)
    reverse: str = "union"         # reverse-edge policy: union | none
    pq_m: int = 8                  # PQ sub-vectors (bytes/vector of the codes)
    pq_k: int = 256                # PQ codewords per sub-quantizer
    pq_iters: int = 15             # k-means iterations at PQ train time
    opq_iters: int = 6             # rotation/codebook alternations (opq only)
    proxy_sample: int = 256        # vertices sampled for the graph-recall
                                   # proxy (0 disables the check)
    n_hubs: int = DEFAULT_N_HUBS   # top in-degree vertices for the hubs seeder
    lid_sample: int = 256          # points sampled for the LID estimate
                                   # (0 disables; paper Tab. I)
    insert_ef: int = 64            # construct='incremental' beam width


class ConstructResult(NamedTuple):
    """Output of one construct stage: the flat graph, an optional hierarchy
    (an :class:`~repro_torch.core.graph_index.HnswIndex` from ``hnsw``),
    JSON-able stats, and the graph the recall proxy scores when it differs
    from ``graph``."""

    graph: KnnGraph
    hierarchy: object | None
    stats: dict
    proxy_graph: KnnGraph | None = None


CONSTRUCTORS: dict[str, Callable] = {}
DIVERSIFIERS: dict[str, Callable] = {}
COMPRESSORS: dict[str, Callable] = {}


def _get(registry: dict, kind: str, name: str):
    if name not in registry:
        raise ValueError(
            f"unknown {kind} stage {name!r}; registered: {sorted(registry)}"
        )
    return registry[name]


def register_constructor(name: str):
    """Register ``fn(base, spec, seed, verbose) -> ConstructResult``."""
    def deco(fn):
        CONSTRUCTORS[name] = fn
        return fn
    return deco


def register_diversifier(name: str):
    """Register ``fn(base, graph, spec) -> (KnnGraph, stats dict)``; stats
    carry ``dropped_reverse_edges``."""
    def deco(fn):
        DIVERSIFIERS[name] = fn
        return fn
    return deco


def register_compressor(name: str):
    """Register ``fn(base, spec, seed) -> compressed index | None``."""
    def deco(fn):
        COMPRESSORS[name] = fn
        return fn
    return deco


# -- construct stages ---------------------------------------------------------


def _nd_config(spec: BuildSpec):
    from .nndescent import NNDescentConfig

    cfg = NNDescentConfig(k=spec.graph_k, rounds=spec.nd_rounds,
                          delta=spec.nd_delta)
    # the local join samples at most k neighbors per list
    return cfg._replace(sample=min(cfg.sample, spec.graph_k),
                        sample_nn=min(cfg.sample_nn, spec.graph_k))


@register_constructor("nndescent")
def _construct_nndescent(base, spec: BuildSpec, seed, verbose) -> ConstructResult:
    from .nndescent import build_knn_graph_with_stats

    graph, st = build_knn_graph_with_stats(base, _nd_config(spec),
                                           metric=spec.metric, seed=seed,
                                           verbose=verbose)
    return ConstructResult(graph, None, {
        "rounds": st.rounds, "update_curve": list(st.update_curve),
        "converged": st.converged,
    })


@register_constructor("exact")
def _construct_exact(base, spec: BuildSpec, seed, verbose) -> ConstructResult:
    from .bruteforce import exact_knn_graph

    k = min(spec.graph_k, base.shape[0] - 1)
    graph = exact_knn_graph(base, k, metric=spec.metric)
    return ConstructResult(graph, None,
                           {"rounds": 0, "update_curve": [], "converged": True})


@register_constructor("incremental")
def _construct_incremental(base, spec: BuildSpec, seed, verbose) -> ConstructResult:
    """Streaming construction: every point arrives through
    ``MutableIndex.insert``, by beam search and link (``spec.insert_ef >
    0``) with ``spec.diversify`` applied inline, or by exact-scan
    maintenance (``insert_ef = 0``), which equals ``construct='exact'`` bit
    for bit at matched capacity. The stats' ``inline_diversify`` tells
    :class:`GraphBuilder` to skip the global diversify stage."""
    from .mutable import MutableIndex

    n, d = base.shape
    idx = MutableIndex.empty(
        d, min(spec.graph_k, max(n - 1, 1)), capacity=n, metric=spec.metric,
        rng_seed=seed, insert_ef=spec.insert_ef, diversify=spec.diversify,
        max_keep=spec.max_keep, device=base.device)
    t0 = time.perf_counter()
    idx.insert_batch(base.cpu().numpy())
    wall = time.perf_counter() - t0
    return ConstructResult(idx.live_graph(), None, {
        "rounds": 0, "update_curve": [], "converged": True,
        "inline_diversify": spec.diversify, "inserts": n,
        "insert_rate": round(n / max(wall, 1e-9), 1),
    })


@register_constructor("hnsw")
def _construct_hnsw(base, spec: BuildSpec, seed, verbose) -> ConstructResult:
    """Layered construction: the NN-Descent bottom graph shared into
    ``build_hnsw``. The bottom layer is the flat graph; HNSW
    occlusion-prunes every layer itself, so this construct pairs with
    ``diversify='none'`` (enforced by :class:`GraphBuilder`)."""
    from .hnsw import HnswConfig, build_hnsw_with_stats
    from .nndescent import build_knn_graph_with_stats

    g, st = build_knn_graph_with_stats(base, _nd_config(spec), metric=spec.metric,
                                       seed=seed, verbose=verbose)
    m = spec.hnsw_m or max(8, spec.graph_k // 2)
    idx, layers = build_hnsw_with_stats(base, HnswConfig(M=m, knn_k=spec.graph_k),
                                        metric=spec.metric, seed=seed, bottom_graph=g,
                                        verbose=verbose)
    dropped = sum(layer["dropped_reverse_edges"] for layer in layers)
    return ConstructResult(idx.bottom_graph(), idx, {
        "rounds": st.rounds, "update_curve": list(st.update_curve),
        "converged": st.converged, "layers": layers,
        "dropped_reverse_edges": dropped,
    }, proxy_graph=g)


# -- diversify stages ---------------------------------------------------------


def _check_reverse(spec: BuildSpec) -> None:
    if spec.reverse not in REVERSE_POLICIES:
        raise ValueError(
            f"unknown reverse-edge policy {spec.reverse!r}; one of "
            f"{REVERSE_POLICIES}"
        )


def _truncation_drops(neighbors, max_degree: int) -> int:
    """Valid edges a ``pad_neighbors`` cap would evict."""
    if max_degree >= neighbors.shape[1]:
        return 0
    return int((neighbors[:, max_degree:] != INVALID).sum())


def _nan_graph(neighbors) -> KnnGraph:
    return KnnGraph(neighbors=neighbors,
                    dists=torch.full(neighbors.shape, float("nan"),
                                     device=neighbors.device))


def _finish_prune(kept, spec: BuildSpec, default_degree: int):
    """Shared tail of the prunes: reverse-edge policy + cap + accounting."""
    from .diversify import ReverseUnionStats, add_reverse_edges_with_stats

    max_degree = spec.max_degree or default_degree
    if spec.reverse == "union":
        merged, rstats = add_reverse_edges_with_stats(kept, max_degree)
    else:
        rstats = ReverseUnionStats(
            candidates=0, dropped_slot=0,
            dropped_cap=_truncation_drops(kept, max_degree),
        )
        merged = pad_neighbors(kept, max_degree)
    return _nan_graph(merged), {
        "dropped_reverse_edges": rstats.dropped,
        "reverse_candidates": rstats.candidates,
    }


@register_diversifier("none")
def _diversify_none(base, graph: KnnGraph, spec: BuildSpec):
    dropped = 0
    if spec.max_degree and spec.max_degree != graph.degree:
        dropped = _truncation_drops(graph.neighbors, spec.max_degree)
        graph = _nan_graph(pad_neighbors(graph.neighbors, spec.max_degree))
    return graph, {"dropped_reverse_edges": dropped, "reverse_candidates": 0}


@register_diversifier("gd")
def _diversify_gd(base, graph: KnnGraph, spec: BuildSpec):
    """The paper's hybrid scheme (KGraph+GD): occlusion prune + reverse
    union, default cap L."""
    from .diversify import gd_prune

    kept = gd_prune(base, graph, max_keep=spec.max_keep or None,
                    metric=spec.metric)
    return _finish_prune(kept, spec, default_degree=graph.degree)


@register_diversifier("dpg")
def _diversify_dpg(base, graph: KnnGraph, spec: BuildSpec):
    """DPG [Li TKDE'19]: angular max-min + reverse union, default cap
    2 * keeps (DPG keeps the full union, ~2x GD's index size)."""
    from .diversify import dpg_prune

    kept = dpg_prune(base, graph, max_keep=spec.max_keep or None)
    default_degree = 2 * (spec.max_keep or graph.degree // 2)
    return _finish_prune(kept, spec, default_degree=default_degree)


# -- compress stages ----------------------------------------------------------


@register_compressor("none")
def _compress_none(base, spec: BuildSpec, seed):
    return None


@register_compressor("pq")
def _compress_pq(base, spec: BuildSpec, seed):
    """Train codebooks and encode codes at build time, from the engine's
    lazy-path seed (``derive_pq_key``), so the attached table equals what a
    fresh engine with the same seed would train on first use."""
    from ..baselines.pq import build_pq, derive_pq_key

    return build_pq(base, M=spec.pq_m, K=spec.pq_k, iters=spec.pq_iters,
                    key=derive_pq_key(seed))


@register_compressor("opq")
def _compress_opq(base, spec: BuildSpec, seed):
    """OPQ: codebook training alternated with a closed-form orthogonal
    Procrustes rotation; the engine rotates queries in ``scorer_state``."""
    from ..baselines.pq import build_opq, derive_opq_key

    return build_opq(base, M=spec.pq_m, K=spec.pq_k, iters=spec.pq_iters,
                     key=derive_opq_key(seed), opq_iters=spec.opq_iters)


# -- report -------------------------------------------------------------------


@dataclasses.dataclass
class BuildReport:
    """Provenance + quality accounting of one build (JSON-able via
    :meth:`summary`). Same fields as the reference's, plus the peak device
    memory of each stage on a GPU."""

    spec: BuildSpec
    n: int
    d: int
    rounds: int                       # NN-Descent rounds executed (0 = exact)
    update_curve: tuple[int, ...]     # per-round new-entry counts
    converged: bool                   # early-termination fired
    graph_recall_proxy: float         # sampled fraction of true k-NN edges
                                      # present in the CONSTRUCTED graph
                                      # (-1.0 when proxy_sample=0)
    degree: dict                      # realized degree distribution (final)
    dropped_reverse_edges: int        # slot overflow + cap evictions
    wall_construct_s: float
    wall_diversify_s: float
    wall_compress_s: float
    wall_total_s: float
    memory_bytes: int                 # graph + PQ codebooks and codes
    layers: list = dataclasses.field(default_factory=list)
    in_degree: dict = dataclasses.field(default_factory=dict)
    hub_ids: list = dataclasses.field(default_factory=list)
    lid: float = -1.0
    inserts: int = 0
    insert_rate: float = -1.0
    staleness: float = 0.0
    # torch.cuda.max_memory_allocated() over each stage (empty on the CPU)
    peak_memory_bytes: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> dict:
        d = dataclasses.asdict(self)
        d["spec"] = self.spec._asdict()
        d["update_curve"] = list(self.update_curve)
        return d


class BuildResult(NamedTuple):
    """What one ``GraphBuilder.build`` hands back."""

    graph: KnnGraph
    hierarchy: object | None
    pq: object | None             # baselines.pq.PQIndex
    report: BuildReport
    hubs: torch.Tensor | None = None  # (n_hubs,) int32, in-degree descending

    @property
    def neighbors(self) -> torch.Tensor:
        return self.graph.neighbors


def graph_recall_proxy(base, graph: KnnGraph, metric: str = "l2",
                       k: int = 10, sample: int = 256) -> float:
    """Sampled graph quality: fraction of true k-NN edges present in the
    adjacency, measured on ``sample`` evenly spaced vertices
    (deterministic, no seed)."""
    from .bruteforce import exact_search

    n = graph.n
    k = min(k, graph.degree, n - 1)
    s = min(sample, n)
    rows = torch.arange(s, dtype=torch.int64, device=base.device) * (n // s)
    # k+1 then drop self by id (robust for non-l2 metrics)
    _, ids = exact_search(base[rows], base, k + 1, metric)
    notself = ids != rows[:, None]
    _, order = torch.sort((~notself).to(torch.int8), dim=1, stable=True)
    exact_ids = ids.gather(1, order)[:, :k]
    nbrs = graph.neighbors[rows]
    hit = (exact_ids[:, :, None] == nbrs[:, None, :]).any(-1)
    return float(hit.float().mean())


class _StageClock:
    """Wall seconds and (on a GPU) peak device memory of one build stage;
    synchronises the device at both ends so the wall covers the work."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device

    def start(self) -> float:
        if self.cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        return time.perf_counter()

    def stop(self, t0: float, name: str, peaks: dict) -> float:
        if self.cuda:
            torch.cuda.synchronize(self.device)
            peaks[name] = int(torch.cuda.max_memory_allocated(self.device))
        return time.perf_counter() - t0


# -- the builder --------------------------------------------------------------


class GraphBuilder:
    """(construct · diversify · compress), validated up front."""

    def __init__(self, spec: BuildSpec):
        self.spec = spec
        self._construct = _get(CONSTRUCTORS, "construct", spec.construct)
        self._diversify = _get(DIVERSIFIERS, "diversify", spec.diversify)
        self._compress = _get(COMPRESSORS, "compress", spec.compress)
        _check_reverse(spec)
        if spec.construct == "hnsw" and spec.diversify != "none":
            raise ValueError(
                "construct='hnsw' occlusion-prunes every layer at build time; a "
                "second diversify stage would desync the bottom layer from the "
                "hierarchy: use diversify='none'")

    def build(self, base: torch.Tensor, seed: int = 0,
              verbose: bool = False) -> BuildResult:
        """Run the three stages on ``base``'s device (float32 (n, d))."""
        from .lid import lid_mle

        spec = self.spec
        if spec.compress in ("pq", "opq") and base.shape[1] % spec.pq_m:
            raise ValueError(
                f"compress={spec.compress!r} needs d % pq_m == 0 "
                f"(d={base.shape[1]}, pq_m={spec.pq_m})"
            )
        base = base.float().contiguous()
        clock = _StageClock(base.device)
        peaks: dict[str, int] = {}

        t0 = clock.start()
        cres = self._construct(base, spec, seed, verbose)
        wall_construct = clock.stop(t0, "construct", peaks)

        proxy = -1.0
        if spec.proxy_sample:
            proxy_graph = (cres.proxy_graph if cres.proxy_graph is not None
                           else cres.graph)
            proxy = graph_recall_proxy(base, proxy_graph, metric=spec.metric,
                                       sample=spec.proxy_sample)

        t2 = clock.start()
        if cres.stats.get("inline_diversify"):
            # the construct diversified per insert; a second pass would
            # prune the same edges again
            graph, dstats = cres.graph, {"dropped_reverse_edges": 0}
        else:
            graph, dstats = self._diversify(base, cres.graph, spec)
        wall_diversify = clock.stop(t2, "diversify", peaks)

        t3 = clock.start()
        pq = self._compress(base, spec, seed)
        wall_compress = clock.stop(t3, "compress", peaks)

        dropped = (dstats["dropped_reverse_edges"]
                   + cres.stats.get("dropped_reverse_edges", 0))
        mem = memory_bytes(cres.hierarchy if cres.hierarchy is not None
                           else graph.neighbors)
        if pq is not None:
            mem += memory_bytes((pq.codebooks, pq.codes))

        # hubs off the FINAL adjacency: the walk the hubs seeder feeds runs
        # on this graph
        hubs = hub_vertices(graph.neighbors, spec.n_hubs)

        lid = -1.0
        if spec.lid_sample:
            # always Euclidean: LID is a geometric property of the point set
            lid = lid_mle(base, k=min(20, base.shape[0] - 2),
                          sample=spec.lid_sample, metric="l2",
                          seed=seed + 0x11D)

        report = BuildReport(
            spec=spec, n=base.shape[0], d=base.shape[1],
            rounds=cres.stats.get("rounds", 0),
            update_curve=tuple(cres.stats.get("update_curve", ())),
            converged=cres.stats.get("converged", True),
            graph_recall_proxy=round(proxy, 4),
            degree=degree_distribution(graph.neighbors),
            dropped_reverse_edges=int(dropped),
            wall_construct_s=round(wall_construct, 4),
            wall_diversify_s=round(wall_diversify, 4),
            wall_compress_s=round(wall_compress, 4),
            wall_total_s=round(wall_construct + wall_diversify + wall_compress, 4),
            memory_bytes=int(mem),
            layers=cres.stats.get("layers", []),
            in_degree=in_degree_distribution(graph.neighbors),
            hub_ids=[int(h) for h in hubs],
            lid=round(lid, 2),
            inserts=int(cres.stats.get("inserts", 0)),
            insert_rate=float(cres.stats.get("insert_rate", -1.0)),
            peak_memory_bytes=peaks,
        )
        return BuildResult(graph=graph, hierarchy=cres.hierarchy, pq=pq,
                           report=report, hubs=hubs)


def build_index(base, spec: BuildSpec = BuildSpec(), seed: int = 0,
                verbose: bool = False) -> BuildResult:
    """One-call convenience: ``GraphBuilder(spec).build(base, seed)``."""
    return GraphBuilder(spec).build(base, seed=seed, verbose=verbose)
