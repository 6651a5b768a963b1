"""Graph-ANN query serving on the PyTorch port (``--arch ann``).

Builds the paper's index (NN-Descent + GD through ``core.build``, plus PQ
codes under ``--scorer pq``), then answers batched query streams through
``Searcher.search`` with random entries and a device-resident base, and
scores recall against brute-force ground truth. ``--scorer`` picks the
per-hop scorer: ``exact`` (float rows), ``sq8`` (uint8 rows) or ``pq``
(M-byte codes against per-query LUTs); the compressed two rerank the
``--rerank`` best survivors exactly (0 = all ef):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch ann --smoke \
        --batch 64 --batches 8 --device cpu [--scorer sq8|pq]

The world is float32 Gaussian, ``(20_000, 32)`` under ``--smoke`` and
``(1_000_000, 64)`` otherwise, made with numpy from ``--seed`` so the same
world can be rebuilt on any device (and by the JAX reference). The query
stream is made and moved to the device before the timer starts, and the
device is synchronised before it stops.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..core.bruteforce import ground_truth
from ..core.build import BuildSpec, GraphBuilder
from ..core.engine import Searcher, SearchSpec
from ..core.topk import recall_at_k

SMOKE_WORLD = (20_000, 32)
FULL_WORLD = (1_000_000, 64)


def numpy_world(n: int, d: int, seed: int = 0) -> np.ndarray:
    """The (n, d) float32 standard-normal base of a serving world."""
    return np.random.default_rng(seed).standard_normal((n, d), dtype=np.float32)


def numpy_queries(d: int, batch: int, batches: int, seed: int = 0) -> list[np.ndarray]:
    """``batches`` query batches of (batch, d), drawn independently of the
    base (stream seed ``seed + 1``)."""
    rng = np.random.default_rng(seed + 1)
    qs = rng.standard_normal((batches * batch, d), dtype=np.float32)
    return [qs[b * batch:(b + 1) * batch] for b in range(batches)]


def batch_seed(seed: int, b: int) -> int:
    """The random-entry seed of query batch ``b``."""
    return seed * 100_003 + 1000 + b


class ServeRun(NamedTuple):
    """Everything one :func:`serve_ann` run made: the printed figures
    (``summary``) and the objects behind them."""

    summary: dict
    searcher: Searcher
    build: object            # core.build.BuildResult
    spec: SearchSpec
    stream: list             # (batch, d) query tensors, in serving order
    seeds: list              # random-entry seed of each batch
    results: list            # SearchResult of each batch
    ground_truth: torch.Tensor


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_searcher(base: torch.Tensor, *, build_k: int = 20,
                   build_rounds: int = 15, diversify: str = "gd",
                   compress: str = "none", pq_m: int = 8, seed: int = 0,
                   verbose: bool = False):
    """NN-Descent + ``diversify`` (+ ``compress``) over ``base`` on its
    device -> (Searcher, BuildResult)."""
    bspec = BuildSpec(construct="nndescent", diversify=diversify,
                      compress=compress, metric="l2", graph_k=build_k,
                      nd_rounds=build_rounds, pq_m=pq_m)
    result = GraphBuilder(bspec).build(base, seed=seed, verbose=verbose)
    return Searcher.from_build(base, result, rng_seed=seed), result


def serve_batches(searcher: Searcher, spec: SearchSpec, stream: list[torch.Tensor],
                  seeds: list[int], stream_tile: int = 0):
    """Answer every batch of ``stream``; returns (results, seconds) with the
    device synchronised after each batch."""
    if stream_tile:
        def do_search(q, s):
            return searcher.search_stream(q, spec, s, tile_q=stream_tile)
    else:
        def do_search(q, s):
            return searcher.search(q, spec, s)
    results = []
    t0 = time.perf_counter()
    for q, s in zip(stream, seeds):
        results.append(do_search(q, s))
        _sync(searcher.device)
    return results, time.perf_counter() - t0


def summarize(results: list, gt: torch.Tensor, topk: int) -> dict:
    """recall@1, recall@topk, comps/query, bytes/query (mean
    ``bytes_touched``) and steps/batch over served batches."""
    found = torch.cat([r.ids for r in results])
    return {
        "recall@1": float((found[:, 0] == gt[:, 0]).float().mean()),
        f"recall@{topk}": recall_at_k(found, gt),
        "comps_per_query": float(torch.cat([r.n_comps for r in results]).float().mean()),
        "bytes_per_query": float(torch.cat([r.bytes_touched for r in results])
                                 .double().mean()),
        "steps_per_batch": float(np.mean([int(r.n_steps) for r in results])),
    }


def serve_ann(args) -> ServeRun:
    """Build, serve ``args.batches`` batches, score recall; prints the
    reference's report lines."""
    device = resolve_device(args.device)
    n, d = SMOKE_WORLD if args.smoke else FULL_WORLD
    base = torch.from_numpy(numpy_world(n, d, args.seed)).to(device)
    compress = "pq" if args.scorer == "pq" else "none"
    searcher, result = build_searcher(
        base, build_k=args.build_k, build_rounds=args.build_rounds,
        diversify=args.diversify, compress=compress, pq_m=args.pq_m,
        seed=args.seed)
    rep = result.report
    print(f"[serve-ann] built nndescent·{args.diversify}·{compress} over n={n} "
          f"d={d} on {device} in {rep.wall_total_s:.1f}s (rounds={rep.rounds}, "
          f"graph-recall~{rep.graph_recall_proxy}, degree "
          f"mean={rep.degree['mean']}, dropped reverse="
          f"{rep.dropped_reverse_edges})")

    spec = searcher.spec(ef=args.ef, k=args.topk, entry="random",
                         scorer=args.scorer, pq_m=args.pq_m, rerank=args.rerank)
    if args.scorer == "pq":
        t0 = time.time()
        attached = searcher.pq
        idx = searcher.pq_index(spec)
        _sync(device)
        source = ("attached" if attached is not None
                  and (attached.M, attached.K) == (idx.M, idx.K)
                  else "trained at startup")
        print(f"[serve-ann] pq scorer ready in {time.time() - t0:.1f}s "
              f"({source}): M={idx.M} K={idx.K} ({idx.M} B/vector vs "
              f"{4 * d} B exact, {4 * d / idx.M:.0f}x smaller scored base)")
    warm = torch.from_numpy(numpy_queries(d, args.batch, 1, args.seed + 99)[0]).to(device)
    serve_batches(searcher, spec, [warm], [batch_seed(args.seed, -1)],
                  args.stream_tile)

    stream = [torch.from_numpy(q).to(device)
              for q in numpy_queries(d, args.batch, args.batches, args.seed)]
    seeds = [batch_seed(args.seed, b) for b in range(args.batches)]
    _sync(device)
    results, dt = serve_batches(searcher, spec, stream, seeds, args.stream_tile)

    # recall/comps over the served traffic; ground truth off the timed path
    all_q = torch.cat(stream)
    gt = ground_truth(all_q, searcher.base, args.topk, searcher.metric)
    served = all_q.shape[0]
    out = {"n": n, "d": d, "device": str(device), "scorer": args.scorer,
           "queries": served, "seconds": dt, "qps": served / dt,
           **summarize(results, gt, args.topk)}
    mode = f"stream[{args.stream_tile}]" if args.stream_tile else "batch"
    print(f"[serve-ann] entry=random scorer={args.scorer} ef={args.ef} "
          f"k={args.topk} mode={mode}: {served} queries in {dt * 1e3:.0f} ms "
          f"({out['qps']:.0f} qps), recall@1={out['recall@1']:.3f}, "
          f"recall@{args.topk}={out[f'recall@{args.topk}']:.3f}, "
          f"comps/query={out['comps_per_query']:.0f}, "
          f"bytes/query={out['bytes_per_query']:.0f}")
    return ServeRun(summary=out, searcher=searcher, build=result, spec=spec,
                    stream=stream, seeds=seeds, results=results,
                    ground_truth=gt)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=["ann"],
                    help="serving family (the port serves graph ANN only)")
    ap.add_argument("--smoke", action="store_true",
                    help="n=20_000, d=32 world instead of n=1_000_000, d=64")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the world, the build and the random entries")
    ap.add_argument("--ef", type=int, default=64, help="beam width")
    ap.add_argument("--topk", type=int, default=10, help="answers per query")
    ap.add_argument("--batch", type=int, default=64, help="queries per batch")
    ap.add_argument("--batches", type=int, default=8, help="batches to serve")
    ap.add_argument("--build-k", type=int, default=20,
                    help="raw k-NN degree out of NN-Descent")
    ap.add_argument("--build-rounds", type=int, default=15,
                    help="NN-Descent round budget")
    ap.add_argument("--diversify", default="gd", choices=["gd", "none"],
                    help="diversify stage")
    ap.add_argument("--scorer", default="exact", choices=["exact", "sq8", "pq"],
                    help="per-hop scorer (sq8/pq: compressed traversal + "
                         "exact rerank)")
    ap.add_argument("--pq-m", type=int, default=8,
                    help="PQ sub-vectors = code bytes/vector")
    ap.add_argument("--rerank", type=int, default=0,
                    help="exact-reranked survivors under sq8/pq (0 = all ef)")
    ap.add_argument("--stream-tile", type=int, default=0,
                    help="split batches into tiles of this many queries "
                         "(0 = one search per batch)")
    return ap


def main(argv=None) -> None:
    serve_ann(parser().parse_args(argv))


if __name__ == "__main__":
    main()
