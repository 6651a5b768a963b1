"""HNSW — hierarchical navigable small-world graphs [Malkov & Yashunin].

The reference's batch-layered construction (``src/repro/core/hnsw.py``):
levels are drawn up front from the exponential distribution (P(level >= l)
= exp(-l / mL), mL = 1/ln M); each layer's graph is a k-NN graph over the
nodes that reach it (exact for layers of up to ``brute_threshold`` nodes,
through ``distance_matrix``; NN-Descent above, through
``gather_distance_pool``), occlusion-pruned with the paper's Fig. 2
heuristic (``gd_prune``, ``distance_matrix``'s small route) and
reverse-unioned, then mapped back to global ids. Search is greedy 1-NN
descent from the top-layer entry point, then the ef-bounded beam on the
bottom layer: the engine's ``hierarchy`` seeder.

Levels draw from a ``torch.Generator`` seeded from an int, not from a
``jax.random`` key, so a built index differs from the reference's; the
build also takes injected ``levels`` (and a ``bottom_graph``), which is how
the tests hand it the reference's draw. ``flat_search`` is the paper's
flat-HNSW control: the bottom layer only, random seeds.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .beam_search import SearchResult
from .bruteforce import exact_knn_graph
from .diversify import add_reverse_edges_with_stats, gd_prune
from .engine import Searcher, SearchSpec, _fold
from .graph_index import HnswIndex, KnnGraph
from .nndescent import NNDescentConfig, build_knn_graph
from .topk import INVALID


class HnswConfig(NamedTuple):
    M: int = 16                 # max neighbors, upper layers
    m0_mult: int = 2            # bottom-layer degree = m0_mult * M (hnswlib)
    knn_k: int = 32             # raw k-NN degree before pruning
    brute_threshold: int = 4096  # exact graph for layers up to this size
    max_layers: int = 6
    nndescent: NNDescentConfig = NNDescentConfig()


def assign_levels(generator: torch.Generator, n: int, cfg: HnswConfig) -> torch.Tensor:
    """Exponentially decaying layer assignment (HNSW Sec. 4), drawn on the
    generator's device: (n,) int32 levels in [0, max_layers)."""
    ml = 1.0 / math.log(cfg.M)
    u = torch.rand(n, generator=generator, device=generator.device)
    u = torch.clamp_min(u * (1.0 - 1e-12) + 1e-12, 1e-12)   # uniform on [1e-12, 1)
    lv = torch.floor(-torch.log(u) * ml).to(torch.int32)
    return torch.clamp_max(lv, cfg.max_layers - 1)


def _layer_graph(base_sub, k, cfg: HnswConfig, metric, seed: int) -> KnnGraph:
    n = base_sub.shape[0]
    k_eff = min(k, n - 1)
    if n <= cfg.brute_threshold:
        return exact_knn_graph(base_sub, k_eff, metric=metric)
    return build_knn_graph(base_sub, cfg.nndescent._replace(k=k_eff), metric=metric,
                           seed=seed)


def build_hnsw_with_stats(
    base: torch.Tensor,
    cfg: HnswConfig = HnswConfig(),
    metric: str = "l2",
    seed: int = 0,
    bottom_graph: KnnGraph | None = None,
    levels: torch.Tensor | None = None,
    verbose: bool = False,
) -> tuple[HnswIndex, list[dict]]:
    """Build the layered index on ``base``'s device plus per-layer
    provenance (node count, degree cap, graph source, dropped reverse
    edges), as the reference's. ``levels`` (n,) int, when given, replaces
    the draw from ``seed``; each NN-Descent layer seeds from (seed, layer)."""
    base = base.float().contiguous()
    n = base.shape[0]
    dev = base.device
    if levels is None:
        levels = assign_levels(torch.Generator(device=dev).manual_seed(seed), n, cfg)
    levels = levels.to(device=dev, dtype=torch.int32)
    num_layers = int(levels.max()) + 1

    layers_neighbors, layers_nodes, layers_slot = [], [], []
    layer_stats: list[dict] = []
    for layer in range(num_layers):
        nodes = torch.nonzero(levels >= layer)[:, 0].to(torch.int32)
        n_l = int(nodes.shape[0])
        if verbose:
            print(f"[hnsw] layer {layer}: {n_l} nodes")
        max_deg = cfg.m0_mult * cfg.M if layer == 0 else cfg.M
        dropped = 0
        if n_l <= 1:
            nbrs_g = torch.full((n_l, max_deg), INVALID, dtype=torch.int32, device=dev)
            source = "trivial"
        else:
            sub = base[nodes.long()] if layer > 0 else base
            if layer == 0 and bottom_graph is not None:
                g = bottom_graph
                source = "bottom_graph"
            else:
                g = _layer_graph(sub, cfg.knn_k, cfg, metric, _fold(seed, layer))
                source = "brute" if n_l <= cfg.brute_threshold else "nndescent"
            kept = gd_prune(sub, g, max_keep=cfg.M, metric=metric)
            merged, rstats = add_reverse_edges_with_stats(kept, max_deg)
            dropped = rstats.dropped
            # local row ids -> global ids
            nbrs_g = torch.where(merged >= 0, nodes[merged.clamp(min=0).long()],
                                 torch.full_like(merged, INVALID))
        slot = torch.full((n,), INVALID, dtype=torch.int32, device=dev)
        slot[nodes.long()] = torch.arange(n_l, dtype=torch.int32, device=dev)
        layers_neighbors.append(nbrs_g)
        layers_nodes.append(nodes)
        layers_slot.append(slot)
        layer_stats.append({"layer": layer, "nodes": n_l, "max_degree": max_deg,
                            "source": source, "dropped_reverse_edges": dropped})

    idx = HnswIndex(
        layers_neighbors=tuple(layers_neighbors),
        layers_nodes=tuple(layers_nodes),
        layers_slot=tuple(layers_slot),
        entry_point=layers_nodes[-1][0].clone(),
        levels=levels,
    )
    return idx, layer_stats


def build_hnsw(base: torch.Tensor, cfg: HnswConfig = HnswConfig(), metric: str = "l2",
               seed: int = 0, bottom_graph: KnnGraph | None = None,
               levels: torch.Tensor | None = None, verbose: bool = False) -> HnswIndex:
    """Build the layered index. ``bottom_graph`` lets one NN-Descent graph
    be shared between HNSW and the flat builds (paper Sec. IV)."""
    idx, _ = build_hnsw_with_stats(base, cfg, metric=metric, seed=seed,
                                   bottom_graph=bottom_graph, levels=levels,
                                   verbose=verbose)
    return idx


def hnsw_search(queries: torch.Tensor, base: torch.Tensor, index: HnswIndex, ef: int,
                k: int = 1, metric: str = "l2", expand_width: int = 1) -> SearchResult:
    """Top-down hierarchical search (paper Sec. III, hnswlib procedure): the
    engine with the ``hierarchy`` seeder over the bottom layer."""
    searcher = Searcher.from_hnsw(base, index, metric=metric)
    spec = SearchSpec(ef=ef, k=k, metric=metric, entry="hierarchy",
                      expand_width=expand_width)
    return searcher.search(queries, spec)


def flat_search(queries: torch.Tensor, base: torch.Tensor, index_or_graph, ef: int,
                k: int = 1, metric: str = "l2", seed: int = 0, n_seeds: int | None = None,
                expand_width: int = 1, entries: torch.Tensor | None = None) -> SearchResult:
    """flat-HNSW (paper Sec. IV): the bottom layer only, random seeds (the
    engine with the ``random`` seeder, drawn from ``seed``), or the given
    ``entries`` (Q, E)."""
    neighbors = (index_or_graph.layers_neighbors[0]
                 if isinstance(index_or_graph, HnswIndex) else index_or_graph.neighbors)
    E = min(n_seeds if n_seeds is not None else ef, ef)
    searcher = Searcher(base, neighbors, metric=metric)
    spec = SearchSpec(ef=ef, k=k, metric=metric, entry="random", n_entries=E,
                      expand_width=expand_width)
    return searcher.search(queries, spec, seed, entries=entries)
