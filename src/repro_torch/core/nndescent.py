"""NN-Descent (KGraph) — approximate k-NN graph construction [Dong WWW'11].

The per-vertex local join of the CPU algorithm runs as fixed-shape rounds,
as in the reference:

  1. sample S neighbors per vertex (new-biased, as in the original),
  2. expand to neighbor-of-neighbor candidates (S x S2 ids per vertex),
  3. add reverse-edge candidates via a random-slot scatter (collisions drop
     entries — NN-Descent is stochastic already),
  4. score all candidates in one call (``ops.gather_distance_pool``; only
     its plain version reads ``cfg.chunk``, rows a step),
  4b. push every scored edge (v -> c, d) back into c's incoming buffer,
  5. merge into the sorted K-list with fixed-shape dedup.

Differences from the reference, all forced by the device:

* Random draws come from a ``torch.Generator`` seeded with ``seed``; the
  graph agrees with the reference statistically (graph recall), not bit
  for bit.
* A scatter with duplicate targets (``index_put_``) picks an unspecified
  winner, independently per call. The reverse and push-back scatters are
  therefore ``scatter_reduce(amax)``: the highest source position wins, as
  the last writer does in the reference's XLA scatter, and the result is
  deterministic on every device. The push-back scatters the flat source
  POSITION once and gathers both the source id and its distance through it,
  so an (id, distance) pair can never come from two sources.
* Steps 1-3 and 5 run over blocks of ``ROW_BLOCK`` vertices so a round's
  peak memory stays at a few GB at n = 1M (the batched stable sorts of the
  284-wide merge rows would otherwise need ~2.3 GB of int64 indices each).

The update counter gives the standard early-termination rule (delta * n * K).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .graph_index import KnnGraph
from .topk import INVALID, dedup_by_id

ROW_BLOCK = 1 << 16   # vertices per block of the round's sampling and merge


class NNDescentConfig(NamedTuple):
    k: int = 20          # neighbors kept per vertex (paper: "several tens")
    sample: int = 12     # S: sampled neighbors for the local join
    sample_nn: int = 12  # S2: sampled entries of each sampled neighbor's list
    reverse: int = 24    # reverse-edge candidate slots
    rounds: int = 15
    delta: float = 0.002  # stop when update-rate < delta
    chunk: int = 1024    # vertices scored per kernel launch


class NNDescentStats(NamedTuple):
    """Convergence provenance of one NN-Descent run: rounds executed, the
    per-round new-entry counts, whether the delta * n * K rule fired, and
    that threshold."""

    rounds: int
    update_curve: tuple[int, ...]
    converged: bool
    threshold: float


def _random_init(gen: torch.Generator, n: int, k: int) -> torch.Tensor:
    """k random neighbors per vertex (self moved to the next id; duplicates
    are dropped by the first merge)."""
    ids = torch.randint(0, n, (n, k), generator=gen, device=gen.device,
                        dtype=torch.int32)
    self_ids = torch.arange(n, device=gen.device, dtype=torch.int32)[:, None]
    return torch.where(ids == self_ids, (ids + 1) % n, ids)


def _score_chunked(base: torch.Tensor, pool: torch.Tensor, metric: str,
                   chunk: int) -> torch.Tensor:
    """pool (n, C) ids -> (n, C) distances to each row's own vertex: one
    call a pass on the card; the plain version takes ``chunk`` rows a step."""
    from ..kernels import ops

    return ops.gather_distance_pool(base, pool.contiguous(), metric, chunk)


def _candidate_pool(ids, isnew, rev, lo, hi, gen, cfg: NNDescentConfig):
    """Steps 1-3 for rows [lo, hi): (hi-lo, C) candidate ids, self masked."""
    n, k = ids.shape
    m = hi - lo
    dev = ids.device
    # 1. new-biased sampling of own neighbors: priority = random + is-new
    prio = torch.rand((m, k), generator=gen, device=dev) + isnew[lo:hi].float()
    sel = torch.argsort(prio, dim=-1, descending=True)[:, : cfg.sample]
    nbr = ids[lo:hi].gather(1, sel)                                 # (m, S)
    # 2. neighbor-of-neighbor expansion: S2 random entries of each list
    cols = torch.randint(0, k, (m, cfg.sample, cfg.sample_nn), generator=gen,
                         device=dev)
    flat = nbr.clamp(min=0).long()[..., None] * k + cols
    nn_cand = ids.reshape(-1)[flat]                                 # (m, S, S2)
    nn_cand = torch.where(nbr[..., None] >= 0, nn_cand,
                          torch.full_like(nn_cand, INVALID)).reshape(m, -1)
    # 3. reverse candidates and a sampled hop through their lists
    rev_b = rev[lo:hi]
    rev_sel = rev_b[:, : max(2, cfg.reverse // 4)]
    rev_nn = ids[:, : cfg.sample_nn][rev_sel.clamp(min=0).long()]
    rev_nn = torch.where(rev_sel[..., None] >= 0, rev_nn,
                         torch.full_like(rev_nn, INVALID)).reshape(m, -1)
    pool = torch.cat([nn_cand, rev_b, rev_nn], dim=1)
    own = torch.arange(lo, hi, device=dev, dtype=torch.int32)[:, None]
    return torch.where(pool == own, torch.full_like(pool, INVALID), pool)


def _round_pool(ids, isnew, gen: torch.Generator, cfg: NNDescentConfig):
    """Steps 1-3 of a round for every vertex: the (n, C) candidate pool."""
    n, k = ids.shape
    dev = ids.device

    # 3. reverse-edge candidates (random-slot scatter; on a collision the
    # highest source id wins)
    slots = torch.randint(0, cfg.reverse, (n, k), generator=gen, device=dev)
    valid = ids >= 0
    src = torch.arange(n, device=dev, dtype=torch.int32)[:, None].expand(n, k)
    rev = torch.full((n * cfg.reverse,), INVALID, dtype=torch.int32, device=dev)
    rev.scatter_reduce_(0, (ids.long() * cfg.reverse + slots)[valid], src[valid],
                        reduce="amax")
    rev = rev.view(n, cfg.reverse)
    return torch.cat([
        _candidate_pool(ids, isnew, rev, lo, min(lo + ROW_BLOCK, n), gen, cfg)
        for lo in range(0, n, ROW_BLOCK)
    ])


def _round(base, ids, dists, isnew, gen: torch.Generator,
           cfg: NNDescentConfig, metric: str):
    n, k = ids.shape
    dev = ids.device
    pool = _round_pool(ids, isnew, gen, cfg)                        # (n, C)

    # 4. score
    cand_d = _score_chunked(base, pool, metric, cfg.chunk)

    # 4b. symmetric push-back: scatter each scored edge's flat position
    # (v * C + j) into a random slot of c's incoming buffer, once (the
    # highest position wins a collision); id and distance are both read
    # through the surviving position
    C = pool.shape[1]
    rb = max(k, cfg.reverse)
    push_pos = torch.full((n * rb,), -1, dtype=torch.int64, device=dev)
    col = torch.arange(C, device=dev)
    for lo in range(0, n, ROW_BLOCK):
        hi = min(lo + ROW_BLOCK, n)
        p = pool[lo:hi]
        pvalid = p >= 0
        pslots = torch.randint(0, rb, p.shape, generator=gen, device=dev)
        tgt = p.long() * rb + pslots
        pos = torch.arange(lo, hi, device=dev)[:, None] * C + col
        push_pos.scatter_reduce_(0, tgt[pvalid], pos[pvalid], reduce="amax")
    push_pos = push_pos.view(n, rb)
    has = push_pos >= 0
    safe_pos = push_pos.clamp(min=0)
    push_i = torch.where(has, (safe_pos // C).to(torch.int32),
                         torch.full_like(push_pos, INVALID, dtype=torch.int32))
    push_d = torch.where(has, cand_d.reshape(-1)[safe_pos],
                         torch.full_like(cand_d[:, :1], float("inf")))
    del push_pos, has, safe_pos

    # 5. merge, block by block
    new_i = torch.empty_like(ids)
    new_d = torch.empty_like(dists)
    new_flag = torch.empty_like(isnew)
    for lo in range(0, n, ROW_BLOCK):
        hi = min(lo + ROW_BLOCK, n)
        d, i = dedup_by_id(
            torch.cat([dists[lo:hi], cand_d[lo:hi], push_d[lo:hi]], dim=1),
            torch.cat([ids[lo:hi], pool[lo:hi], push_i[lo:hi]], dim=1),
        )
        i, d = i[:, :k], d[:, :k]
        # an entry is "new" if its id was not in the previous list
        was_in = (i[:, :, None] == ids[lo:hi, None, :]).any(-1)
        new_flag[lo:hi] = ~was_in & (i != INVALID)
        new_i[lo:hi] = i
        new_d[lo:hi] = d
    return new_i, new_d, new_flag, new_flag.sum()


def build_knn_graph_with_stats(base: torch.Tensor,
                               cfg: NNDescentConfig = NNDescentConfig(),
                               metric: str = "l2", seed: int = 0,
                               verbose: bool = False):
    """Run NN-Descent to convergence on ``base``'s device; returns the
    KGraph-style k-NN graph plus its convergence stats."""
    n = base.shape[0]
    base = base.float().contiguous()
    gen = torch.Generator(device=base.device).manual_seed(seed)
    ids = _random_init(gen, n, cfg.k)
    dists = _score_chunked(base, ids, metric, cfg.chunk)
    dists, ids = dedup_by_id(dists, ids)
    isnew = torch.ones_like(ids, dtype=torch.bool)

    threshold = cfg.delta * n * cfg.k
    curve: list[int] = []
    converged = False
    for r in range(cfg.rounds):
        ids, dists, isnew, n_up = _round(base, ids, dists, isnew, gen, cfg,
                                         metric)
        n_up = int(n_up)
        curve.append(n_up)
        if verbose:
            print(f"[nndescent] round {r}: {n_up} updates")
        if n_up <= threshold:
            converged = True
            break
    stats = NNDescentStats(rounds=len(curve), update_curve=tuple(curve),
                           converged=converged, threshold=threshold)
    return KnnGraph(neighbors=ids, dists=dists), stats


def build_knn_graph(base: torch.Tensor, cfg: NNDescentConfig = NNDescentConfig(),
                    metric: str = "l2", seed: int = 0,
                    verbose: bool = False) -> KnnGraph:
    """Run NN-Descent to convergence; returns the KGraph-style k-NN graph."""
    graph, _ = build_knn_graph_with_stats(base, cfg, metric=metric, seed=seed,
                                          verbose=verbose)
    return graph


def graph_recall(graph: KnnGraph, exact: KnnGraph) -> float:
    """Fraction of true k-NN edges recovered (the KGraph quality metric)."""
    hit = (graph.neighbors[:, :, None] == exact.neighbors[:, None, :]) & (
        exact.neighbors[:, None, :] != INVALID
    )
    return float(hit.any(1).float().mean())
