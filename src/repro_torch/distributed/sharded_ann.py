"""Distributed graph-ANN serving: shard-and-merge, on ``torch.distributed``
(the reference's ``repro/distributed/sharded_ann.py``).

The base and its flat, diversified graph are split into P contiguous
shards: shard p owns rows [p*n/P, (p+1)*n/P) and a graph over its own rows
only (each shard builds it, :func:`shard_build`). Rank p of the flat group
(``launch.mesh.make_flat_group``) holds shard p; queries are replicated.
Each rank runs the engine's beam on its shard (``engine.shard_search``),
and the global answer is an all-gather of the (Q, k) answers and a local
merge of the P*k, the same on every rank. A lost or straggling shard
degrades recall by about n/P candidates instead of failing the query:
``live_mask`` drops its contribution.

Operands keep the reference's stacked layout with a leading shard axis:
builds return (P, ...) stacks, and :func:`distributed_search` takes each
rank's own slice, a leading axis of 1, as the reference's ``shard_map``
body sees it. On a one-rank group the reference's (P=1, ...) stacks go in
unchanged. ``engine.emulated_shard_search`` runs all P shards one after
another in one process, with the same beam and merge.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..core import engine
from ..core.base_store import BaseStore, check_placement, rerank_gathered
from ..core.beam_search import rerank_slice
from ..core.build import BuildResult, BuildSpec, GraphBuilder
from ..core.engine import SearchSpec, _fold, _row_blocked


class ShardBuildResult(NamedTuple):
    """Output of :func:`shard_build`: ``(base_shards, nbr_shards)`` feed
    :func:`distributed_search` and ``engine.emulated_shard_search``, the
    PQ stacks (when ``spec.compress='pq'``) feed ``scorer='pq'`` and the
    host tier as :func:`shard_pq`'s do, and ``reports`` holds each shard's
    :class:`~repro_torch.core.build.BuildReport`."""

    base_shards: torch.Tensor                 # (P, n/P, d)
    nbr_shards: torch.Tensor                  # (P, n/P, R)
    pq_codebooks: torch.Tensor | None         # (P, M, K, dsub) when compress='pq'
    pq_codes: torch.Tensor | None             # (P, n/P, M) uint8 when compress='pq'
    reports: tuple                            # per-shard BuildReport


def _shard_spec(spec: BuildSpec | None, per: int) -> BuildSpec:
    if spec is None:
        spec = BuildSpec()
    if spec.construct == "hnsw":
        raise ValueError(
            "shard_build builds flat per-shard graphs; construct='hnsw' has "
            "no sharded search path (shard_search walks flat adjacency) — "
            "use construct='nndescent'|'exact'"
        )
    return spec._replace(graph_k=min(spec.graph_k, per - 1))


def build_shard(base, n_shards: int, shard: int, *, spec: BuildSpec | None = None,
                seed: int = 0) -> BuildResult:
    """Shard ``shard``'s build: ``spec`` (``graph_k`` capped at n/P - 1) over
    its rows, seeded from ``(seed, shard)``. A rank builds only its own
    shard with this; :func:`shard_build` stacks all of them."""
    per = base.shape[0] // n_shards
    spec = _shard_spec(spec, per)
    rows = base[shard * per:(shard + 1) * per]
    return GraphBuilder(spec).build(rows, seed=_fold(seed, shard))


def shard_build(base, n_shards: int, *, spec: BuildSpec | None = None,
                seed: int = 0) -> ShardBuildResult:
    """The per-shard build pipeline: every shard runs the SAME ``BuildSpec``
    (construct, diversify, compress) over its own rows (:func:`build_shard`),
    so a shard's graph and codes are reproducible from (spec, seed, shard).
    Rows past P * (n // P) are dropped, as the reference drops them.

    ``construct='hnsw'`` is rejected: the shard bodies walk flat adjacency
    only (seed shards with ``engine.shard_entries`` instead)."""
    n = base.shape[0]
    per = n // n_shards
    _shard_spec(spec, per)
    bs, ns, cbs, codes, reports = [], [], [], [], []
    for s in range(n_shards):
        res = build_shard(base, n_shards, s, spec=spec, seed=seed)
        bs.append(base[s * per:(s + 1) * per])
        ns.append(res.graph.neighbors)
        reports.append(res.report)
        if res.pq is not None:
            cbs.append(res.pq.codebooks)
            codes.append(res.pq.codes)
    return ShardBuildResult(
        base_shards=torch.stack(bs),
        nbr_shards=torch.stack(ns),
        pq_codebooks=torch.stack(cbs) if cbs else None,
        pq_codes=torch.stack(codes) if codes else None,
        reports=tuple(reports),
    )


def shard_graph_spec(metric: str = "l2") -> BuildSpec:
    """The per-shard build :func:`shard_graph` runs (the reference's):
    NN-Descent k=20, 10 rounds, GD, no graph-recall proxy."""
    return BuildSpec(construct="nndescent", diversify="gd", graph_k=20, nd_rounds=10,
                     metric=metric, proxy_sample=0)


def shard_graph(base, neighbors, n_shards: int, *, rebuild: bool = True,
                metric: str = "l2", seed: int = 0):
    """Partition the base into contiguous shards with a graph each.

    ``rebuild=True`` (the default): each shard builds its OWN k-NN + GD
    graph over its rows (:func:`shard_build` with :func:`shard_graph_spec`;
    ``neighbors`` is not read). Masking a global graph would orphan most
    vertices, as cross-shard edges dominate a random partition.
    ``rebuild=False`` masks the global ``neighbors`` to each shard's own
    targets, in local ids (the ablation).

    Returns (base_shards (P, n/P, d), nbr_shards (P, n/P, R))."""
    n = base.shape[0]
    per = n // n_shards
    if rebuild:
        res = shard_build(base, n_shards, spec=shard_graph_spec(metric), seed=seed)
        return res.base_shards, res.nbr_shards
    bs, ns = [], []
    for s in range(n_shards):
        lo = s * per
        local = neighbors[lo:lo + per]
        inside = (local >= lo) & (local < lo + per)
        ns.append(torch.where(inside, local - lo, torch.full_like(local, -1)))
        bs.append(base[lo:lo + per])
    return torch.stack(bs), torch.stack(ns)


def shard_pq(base_shards: torch.Tensor, M: int = 8, K: int = 256, iters: int = 15,
             seed: int = 0):
    """Per-shard PQ for the compressed scorer: each shard trains its OWN
    codebooks on its rows, seeded from ``(seed, shard)``. Returns stacked
    (codebooks (P, M, K, dsub), codes (P, n/P, M) uint8)."""
    from ..baselines.pq import build_pq

    cbs, codes = [], []
    for s in range(base_shards.shape[0]):
        idx = build_pq(base_shards[s], M=M, K=K, iters=iters, key=_fold(seed, s))
        cbs.append(idx.codebooks)
        codes.append(idx.codes)
    return torch.stack(cbs), torch.stack(codes)


def pq_shard_state(queries: torch.Tensor, codebooks: torch.Tensor,
                   codes: torch.Tensor, metric: str):
    """A shard's ``pq`` scorer operand: its codes and the batch's ADC LUTs
    against its codebooks, built in ``engine.SCORER_BLOCK``-row blocks as
    ``Searcher.scorer_state`` builds them, so a shard answers with the bits
    of a ``Searcher`` over that shard."""
    from ..baselines.pq import build_adc_luts

    luts = _row_blocked(lambda q: build_adc_luts(q, codebooks, metric), queries)
    return codes, luts.contiguous()


def _own(x, name: str):
    """This rank's shard of a stacked operand (leading axis 1)."""
    if x.shape[0] != 1:
        raise ValueError(f"{name} must hold this rank's own shard (leading axis 1), "
                         f"got shape {tuple(x.shape)}")
    return x[0]


def distributed_search(
    queries: torch.Tensor,            # (Q, d) replicated
    base_shards: torch.Tensor | None,  # (1, n/P, d) this rank's rows (device tier)
    nbr_shards: torch.Tensor,         # (1, n/P, R) this rank's graph
    entry_ids: torch.Tensor,          # (1, Q, E) this rank's local entries
    live_mask: torch.Tensor,          # (1,) bool — False: a failed/straggler shard
    *,
    ef: int,
    k: int,
    metric: str = "l2",
    group=None,
    expand_width: int = 1,
    r_tile: int = 0,
    scorer: str = "exact",
    rerank: int = 0,
    pq_codebooks: torch.Tensor | None = None,   # (1, M, K, dsub), scorer="pq"
    pq_codes: torch.Tensor | None = None,       # (1, n/P, M) uint8, scorer="pq"
    base_placement: str = "device",
    host_base=None,                   # (n, d) host array / BaseStore, host or disk
):
    """Shard-and-merge search over ``group`` (a ``torch.distributed`` group,
    None the default; rank p passes shard p): every shard runs the SAME beam
    core (``engine.shard_search``). Returns (dists (Q, k), global ids (Q, k),
    comps (Q,)), the same on every rank.

    ``scorer="pq"`` traverses each shard on its own code table
    (:func:`shard_pq`): the ADC LUTs are built here from the replicated
    queries and the shard's codebooks (:func:`pq_shard_state`), and the
    in-shard exact rerank restores exact distances before the merge.

    ``base_placement="host"`` keeps no float shard on the device: the shards
    traverse codes only and all-gather their top-``rerank`` survivors
    (``engine.shard_traverse``); the exact rerank and merge then run on
    every rank against the one global ``host_base``. ``"disk"`` is the same
    with the base behind mmap'd shards (a ``BaseStore.from_shards``, or an
    array to spill). The comparisons are scaled ``raw * M // d`` after the
    reduction, plus one a surviving id."""
    queries = queries.float().contiguous()
    spec = SearchSpec(ef=ef, k=k, metric=metric, expand_width=expand_width,
                      r_tile=r_tile, scorer=scorer, rerank=rerank,
                      base_placement=base_placement)
    per = nbr_shards.shape[1]
    nbrs, ent, live = (_own(nbr_shards, "nbr_shards"), _own(entry_ids, "entry_ids"),
                       _own(live_mask, "live_mask"))
    if base_placement == "device":
        state = None
        if scorer == "pq":
            if pq_codebooks is None or pq_codes is None:
                raise ValueError("scorer='pq' needs pq_codebooks/pq_codes "
                                 "(see shard_pq)")
            state = pq_shard_state(queries, _own(pq_codebooks, "pq_codebooks"),
                                   _own(pq_codes, "pq_codes"), metric)
        return engine.shard_search(queries, _own(base_shards, "base_shards"), nbrs, ent,
                                   live, spec=spec, group=group, per=per,
                                   scorer_state=state)
    check_placement(base_placement)
    if pq_codebooks is None or pq_codes is None:
        raise ValueError(f"base_placement={base_placement!r} traverses "
                         "per-shard code tables: pass scorer='pq' with "
                         "pq_codebooks/pq_codes (see shard_pq)")
    if host_base is None:
        raise ValueError(f"base_placement={base_placement!r} needs "
                         "host_base= (the global float base: a host array, "
                         "or a BaseStore over mmap'd shards)")
    store = BaseStore.wrap(host_base, base_placement, device=queries.device)
    try:
        state = pq_shard_state(queries, _own(pq_codebooks, "pq_codebooks"),
                               _own(pq_codes, "pq_codes"), metric)
        flat_i, raw_comps = engine.shard_traverse(
            queries, nbrs, ent, live, spec=spec, group=group, per=per,
            r=rerank_slice(ef, k, rerank), scorer_state=state)
        rows, _ = store.gather(flat_i)          # (Q, P*r, d)
        md, mi = rerank_gathered(queries, flat_i, rows, k=k, metric=metric)
        comps = (raw_comps * pq_codes.shape[-1]) // store.d  # ADC hops at M/d
        comps = comps + (flat_i >= 0).sum(dim=1, dtype=torch.int32)
    finally:
        if store is not host_base:   # a store spilled here goes with the call
            store.close()
    return md, mi, comps


def distributed_build_and_search(base: torch.Tensor, queries: torch.Tensor, group=None,
                                 ef: int = 64, k: int = 1, metric: str = "l2",
                                 seed: int = 0):
    """Convenience wrapper: each rank builds its own shard's graph
    (:func:`shard_graph`'s per-shard build), draws its entries from
    ``(seed)`` and searches with every shard live. (The reference also
    builds a global graph first, which its per-shard rebuild never reads;
    the port skips it.)"""
    P, rank = dist.get_world_size(group), dist.get_rank(group)
    per = base.shape[0] // P
    res = build_shard(base, P, rank, spec=shard_graph_spec(metric), seed=seed)
    gen = torch.Generator(device=queries.device).manual_seed(seed)
    ent = engine.shard_entries(gen, P, queries.shape[0], per, min(8, ef))
    live = torch.ones((1,), dtype=torch.bool, device=queries.device)
    return distributed_search(
        queries, base[None, rank * per:(rank + 1) * per], res.graph.neighbors[None],
        ent[rank:rank + 1], live, ef=ef, k=k, metric=metric, group=group)
