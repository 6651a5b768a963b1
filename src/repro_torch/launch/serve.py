"""Query serving on the PyTorch port: graph ANN (``--arch ann``), greedy
LM decoding (``--arch tinyllama-1.1b | h2o-danube-1.8b | qwen3-moe-30b-a3b |
gemma3-12b | deepseek-v3-671b``) and item retrieval under the inner product
for the recsys and GNN archs.

Builds the paper's index through ``core.build`` (``--build-construct``:
NN-Descent + GD by default, HNSW with no diversify stage for ``--entry
hierarchy``, ``exact``, or ``incremental``: streaming inserts through
``core.mutable.MutableIndex`` with ``--diversify`` applied per insert;
``--diversify none|gd|dpg``; plus PQ codes under ``--scorer pq``), then
answers batched query streams through ``Searcher.search``, and
scores recall against brute-force ground truth. ``--entry`` picks where the
beam starts: ``random`` (flat-HNSW), ``projection``, ``hierarchy`` (HNSW's
greedy descent), ``lsh`` (the SRS probe) or ``hubs``; ``--term stable``
(with ``--stable-steps``) and ``--restarts`` make stopping per query.
``--scorer`` picks the per-hop scorer: ``exact`` (float rows), ``sq8``
(uint8 rows) or ``pq`` (M-byte codes against per-query LUTs); the
compressed two rerank the ``--rerank`` best survivors exactly (0 = all ef):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch ann --smoke \
        --batch 64 --batches 8 --device cpu [--scorer sq8|pq] \
        [--entry hierarchy|hubs|projection|lsh] [--term stable] [--restarts 1]

``--index path.npz`` loads a saved index artifact (``core.io``, the
reference's format: flat graph, hierarchy, PQ codes, hubs, metadata and
key) when the file exists, and otherwise builds and saves one there;
``--save-index`` writes elsewhere (re-saving a loaded artifact migrates a
legacy file to the current schema). A reloaded index runs no NN-Descent
and no k-means. ``--base-placement host|disk`` keeps the float base in
host memory or in mmap'd shards and reranks from there (needs ``--scorer
pq`` or ``sq8``); ``--store-dtype bf16`` halves the tier's rows.

``--serve`` answers ragged Poisson request traffic through the
continuous-batching server (``launch.server.AnnServer``, driven by
``launch.loadgen``) instead of pre-formed batches: ``--serve-requests``
requests of ``--request-sizes`` rows offered at ``--serve-qps`` rows/s,
padded to ``--serve-buckets``, ``--max-live-batches`` in flight and
``--queue-depth`` queued before submits are shed. ``--serve-mutate N`` then
inserts N points and tombstones N/2 through ``core.mutable.MutableIndex``,
hot-swaps the mutated index into the live server and serves a second
stream:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch ann --smoke \
        --device cpu --serve [--serve-mutate 50]

The world is float32 Gaussian, ``(20_000, 32)`` under ``--smoke`` and
``(1_000_000, 64)`` otherwise, made with numpy from ``--seed`` so the same
world can be rebuilt on any device (and by the JAX reference). The query
stream is made and moved to the device before the timer starts, and the
device is synchronised before it stops.

An LM arch (the reference's ``--arch`` LM branch) initialises the model
from ``--seed`` (random weights; ``--smoke`` takes the arch's reduced
config) and decodes ``--tokens`` greedy steps for ``--batch`` sequences
from token 0 at positions 0..T-1 against caches of ``--max-len``, then
prints tok/s and ms/token:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --smoke --tokens 32 --batch 2 --device cpu

Qwen3-MoE runs its experts through the reference's GShard dispatch (each
batch row a group; at decode every row is a group of one token, C = 1);
Gemma3's 5 local : 1 global layers keep ring caches of 1024 slots on the
local layers and ``--max-len`` on the global ones. DeepSeek-V3's MLA layers
(3 dense-FFN layers, then 58 MoE layers) cache the 512-wide latent and the
64-wide RoPE key and decode through the absorbed product; its full config
holds 671,712,655,360 parameters (~1.25 TiB in bf16), more than one card
holds, so on one card it runs with ``--smoke``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b \
        --smoke --device cpu

A recsys or GNN arch (``dlrm-mlperf``, ``deepfm``, ``autoint``,
``bert4rec``, ``graphsage-reddit``) runs the reference's non-LM branch: the
item-retrieval workload those models serve. Items (``(1_000_000, 64)``, or
``(20_000, 32)`` under ``--smoke``) and ``--batch`` queries (default 2) come
from ``--seed`` as the ANN world does; exact inner-product retrieval of the
top 10 (``models.recsys.retrieval_score_exact``), an NN-Descent graph (k=16,
8 rounds) pruned by GD, both under ``ip``, and the beam over it
(``retrieval_score_ann``, ef=96, k=10, 16 random entries); it prints exact
ms, ANN ms and recall@1 (and the build's seconds, recall@10 and
comps/query):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm-mlperf \
        --smoke --device cpu --batch 64
"""
from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import configs
from .._device import resolve_device
from ..core import io as index_io
from ..core.bruteforce import ground_truth
from ..core.build import BuildSpec, GraphBuilder
from ..core.diversify import build_gd_graph
from ..core.engine import Searcher, SearchSpec, _fold
from ..core.nndescent import NNDescentConfig, build_knn_graph
from ..core.topk import recall_at_k
from ..models import recsys
from ..models import transformer as tf

SMOKE_WORLD = (20_000, 32)
FULL_WORLD = (1_000_000, 64)
# the reference's recsys / GNN serve branch: its graph, beam and answers
RETRIEVAL_KNN = NNDescentConfig(k=16, rounds=8)
RETRIEVAL_EF = 96
RETRIEVAL_K = 10


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
    build: object            # core.build.BuildResult (None for a loaded index)
    spec: SearchSpec
    stream: list             # (batch, d) query tensors, in serving order
    seeds: list              # random-entry seed of each batch
    results: list            # SearchResult of each batch
    ground_truth: torch.Tensor
    served: object = None    # --serve: the ServedStreams behind summary["serve"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_searcher(base: torch.Tensor, *, construct: str = "nndescent",
                   build_k: int = 20, build_rounds: int = 15, diversify: str = "gd",
                   compress: str = "none", pq_m: int = 8, seed: int = 0,
                   verbose: bool = False):
    """``construct`` + ``diversify`` (+ ``compress``) over ``base`` on its
    device -> (Searcher, BuildResult); an ``hnsw`` build binds its
    hierarchy to the Searcher."""
    bspec = BuildSpec(construct=construct, diversify=diversify,
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


class ServedStreams(NamedTuple):
    """What ``--serve`` ran: the server, the query pool and its ground
    truth, each stream's request specs with the Searcher that served it,
    and (under ``--serve-mutate``) the mutated index and its tombstones."""

    server: object               # launch.server.AnnServer
    pool: np.ndarray
    ground_truth: np.ndarray     # (256, 1) over the serving index
    streams: list                # [(requests, Searcher that served them)]
    mutable: object = None       # core.mutable.MutableIndex
    dead: np.ndarray | None = None


def serve_open_loop(searcher: Searcher, spec: SearchSpec, args, seed: int):
    """``--serve``: ragged Poisson request traffic through the
    continuous-batching server: bucket padding, admission cap, queue-depth
    shedding, p50/p90/p99 over per-request enqueue->complete latency.
    Returns (summary dict, :class:`ServedStreams`)."""
    from . import loadgen
    from .server import AnnServer, ServeConfig

    sizes = tuple(int(x) for x in args.request_sizes.split(","))
    config = ServeConfig(
        buckets=tuple(int(b) for b in args.serve_buckets.split(",")),
        max_live_batches=args.max_live_batches,
        max_queue_depth=args.queue_depth,
    )
    server = AnnServer(searcher, spec, config)
    dev = searcher.device
    d = searcher.base.shape[1]
    pool = np.random.default_rng(_fold(seed, 11)).standard_normal((256, d), dtype=np.float32)
    requests = loadgen.make_requests(pool, args.serve_requests, sizes, seed=0,
                                     base_seed=_fold(searcher.rng_seed, 777))
    server.warmup()   # every request shape, off the timed path

    mean_size = sum(r.rows.shape[0] for r in requests) / len(requests)
    arrivals = loadgen.poisson_arrivals(args.serve_qps / mean_size, len(requests), seed=0)
    loadgen.run_open_loop(server, requests, arrivals)
    st = server.stats()

    # recall/comps over the served traffic (ground truth off the timed
    # path; shed requests produced no answers)
    gt = ground_truth(torch.from_numpy(pool).to(dev), searcher.base, 1,
                      searcher.metric).cpu().numpy()
    recall, comps = loadgen._recall_comps(server.completed, requests, gt)
    print(f"[serve-ann] open loop: offered {args.serve_qps:.0f} qps over "
          f"{len(requests)} requests (sizes {sizes}), buckets "
          f"{config.buckets}, {config.max_live_batches} live / "
          f"{config.max_queue_depth} queued max")
    print(f"[serve-ann] served {st['completed']} requests "
          f"({st['shed']} shed): p50={st.get('p50_ms')} ms "
          f"p90={st.get('p90_ms')} ms p99={st.get('p99_ms')} ms, "
          f"queue wait {st.get('mean_queue_ms')} ms, sustained "
          f"{st.get('sustained_qps')} qps, fill {st['mean_fill']}, "
          f"buckets {st['bucket_counts']}")
    print(f"[serve-ann] served recall@1={recall:.3f}, "
          f"comps/query={comps:.0f}, largest live window {st['max_live']}")
    out = {**st, "offered_qps": args.serve_qps, "requests": len(requests),
           "recall@1": recall, "comps_per_query": comps}
    served = ServedStreams(server=server, pool=pool, ground_truth=gt,
                           streams=[(requests, searcher)])
    if not args.serve_mutate:
        return out, served

    # --serve-mutate: mutate the index under the live server, hot-swap it
    # in (warmed before the flip), and serve a second stream through the
    # same server
    from ..core.mutable import MutableIndex

    n_ins = args.serve_mutate
    n0 = searcher.base.shape[0]
    midx = MutableIndex(searcher.base, searcher.neighbors, metric=searcher.metric,
                        rng_seed=searcher.rng_seed, insert_ef=32, diversify="gd",
                        device=dev)
    t_m = time.monotonic()
    midx.insert_batch(np.random.default_rng(_fold(seed, 21)).standard_normal(
        (n_ins, d), dtype=np.float32))
    dead = np.random.default_rng(0).choice(n0, size=max(n_ins // 2, 1), replace=False)
    midx.delete(dead)
    _sync(dev)
    mutate_s = time.monotonic() - t_m
    s1 = midx.searcher()
    version = server.swap(s1, seed=_fold(seed, 23))
    ev = server.swap_events[-1]
    print(f"[serve-ann] hot-swap v{version}: +{n_ins} inserts "
          f"({midx.insert_rate:.0f} pts/s) -{len(dead)} tombstones in "
          f"{mutate_s:.2f}s, staleness={midx.staleness:.3f}; warm+flip "
          f"{ev['warm_s']:.2f}s with {ev['live_at_flip']} live / "
          f"{ev['queued_at_flip']} queued at the flip")
    done0, shed0 = st["completed"], st["shed"]
    requests2 = loadgen.make_requests(pool, args.serve_requests, sizes, seed=1,
                                      base_seed=_fold(searcher.rng_seed, 778))
    loadgen.run_open_loop(server, requests2,
                          loadgen.poisson_arrivals(args.serve_qps / mean_size,
                                                   len(requests2), seed=1))
    st2 = server.stats()
    dead_set = set(int(i) for i in dead)
    dead_hits = sum(int(i) in dead_set for req in server.completed[done0:]
                    for i in req.ids.ravel())
    print(f"[serve-ann] post-swap stream: "
          f"{st2['completed'] - done0} served "
          f"({st2['shed'] - shed0} shed), p99={st2.get('p99_ms')} ms "
          f"cumulative, tombstoned ids in answers: {dead_hits} "
          f"(must be 0)")
    out["mutate"] = {"inserts": n_ins, "deleted": int(dead.size), "mutate_s": mutate_s,
                     "swap": ev, "completed": st2["completed"] - done0,
                     "shed": st2["shed"] - shed0, "p99_ms": st2.get("p99_ms"),
                     "dead_hits": dead_hits, "max_live": st2["max_live"]}
    return out, served._replace(streams=served.streams + [(requests2, s1)],
                                mutable=midx, dead=dead)


def build_stages(args) -> tuple[str, str]:
    """(construct, diversify) for the serve flags: ``auto`` builds HNSW for
    ``--entry hierarchy``, else NN-Descent; the diversify stage defaults to
    ``none`` under HNSW (it prunes every layer itself), else ``gd``."""
    construct = args.build_construct
    if construct == "auto":
        construct = "hnsw" if args.entry == "hierarchy" else "nndescent"
    diversify = args.diversify
    if diversify is None:
        diversify = "none" if construct == "hnsw" else "gd"
    return construct, diversify


def seed_comps(searcher: Searcher, spec: SearchSpec, stream: list, seeds: list) -> float:
    """Mean seed-phase comparisons a query over the stream (the entry
    strategy's share of comps/query), seeded again off the timed path."""
    comps = [searcher.seed(q, spec, s)[1] for q, s in zip(stream, seeds)]
    return float(torch.cat(comps).float().mean())


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


def load_or_build(args, device: torch.device):
    """``--index``: load the artifact where it exists (re-saving it to
    ``--save-index`` when that names another file), else build the world's
    index and save it to ``--save-index`` or ``--index``. Returns
    (Searcher, BuildResult or None, HNSW layer sizes)."""
    index_path = index_io.normalize_path(args.index) if args.index else None
    save_path = (index_io.normalize_path(args.save_index) if args.save_index
                 else index_path)
    if index_path and os.path.exists(index_path):
        art = index_io.load_index(index_path)
        searcher = art.to_searcher(device)
        hier = art.hierarchy
        layer_sizes = [] if hier is None else [int(x.shape[0]) for x in hier.layers_nodes]
        print(f"[serve-ann] loaded artifact {index_path} (v{art.version}): "
              f"n={art.n} d={art.d} metric={art.metric} layers={len(layer_sizes)} "
              f"pq={'yes' if art.pq is not None else 'no'}")
        if args.entry == "hierarchy" and searcher.hierarchy is None:
            raise SystemExit("--entry hierarchy: this artifact has no hierarchy; rebuild "
                             "with --build-construct hnsw --save-index " + index_path)
        if args.save_index and save_path != index_path:
            p = index_io.save_index(save_path, index_io.IndexArtifact.from_searcher(
                searcher, art.provenance))
            print(f"[serve-ann] re-saved loaded index to {p} "
                  f"(schema v{index_io.ARTIFACT_VERSION})")
        return searcher, None, layer_sizes

    n, d = SMOKE_WORLD if args.smoke else FULL_WORLD
    base = torch.from_numpy(numpy_world(n, d, args.seed)).to(device)
    compress = "pq" if args.scorer == "pq" else "none"
    construct, diversify = build_stages(args)
    searcher, result = build_searcher(
        base, construct=construct, build_k=args.build_k,
        build_rounds=args.build_rounds, diversify=diversify, compress=compress,
        pq_m=args.pq_m, seed=args.seed)
    rep = result.report
    print(f"[serve-ann] built {construct}·{diversify}·{compress} over n={n} "
          f"d={d} on {device} in {rep.wall_total_s:.1f}s (rounds={rep.rounds}, "
          f"graph-recall~{rep.graph_recall_proxy}, degree "
          f"mean={rep.degree['mean']}, dropped reverse="
          f"{rep.dropped_reverse_edges})")
    if rep.inserts:
        print(f"[serve-ann] incremental construct: {rep.inserts} inserts at "
              f"{rep.insert_rate:.1f} inserts/s, diversified per insert")
    layer_sizes = [layer["nodes"] for layer in rep.layers]
    if layer_sizes:
        print(f"[serve-ann] hnsw layers (nodes, bottom first): {layer_sizes}; sources "
              f"{[layer['source'] for layer in rep.layers]}")
    if save_path:
        p = index_io.save_index(save_path, index_io.IndexArtifact.from_build(
            base, result, metric="l2", rng_seed=args.seed))
        print(f"[serve-ann] saved index artifact to {p} (hierarchy and PQ persist: "
              f"reloads skip both rebuild and k-means)")
    return searcher, result, layer_sizes


def serve_ann(args) -> ServeRun:
    """Load or build the index, serve ``args.batches`` batches, score
    recall; prints the reference's report lines."""
    device = resolve_device(args.device)
    searcher, result, layer_sizes = load_or_build(args, device)
    n, d = searcher.base.shape

    spec = searcher.spec(ef=args.ef, k=args.topk, entry=args.entry,
                         scorer=args.scorer, pq_m=args.pq_m, rerank=args.rerank,
                         base_placement=args.base_placement,
                         store_dtype=args.store_dtype,
                         term=args.term, stable_steps=args.stable_steps,
                         restarts=args.restarts)
    if args.base_placement != "device" and args.scorer == "exact":
        raise SystemExit(f"--base-placement {args.base_placement} traverses "
                         "device-resident compressed codes; add --scorer pq "
                         "or --scorer sq8")
    store = None
    if args.base_placement != "device":
        # the rerank's rows come from here; the device keeps the compressed
        # table, the adjacency (and Searcher.base, as the reference keeps it)
        store = searcher.base_store(args.base_placement, args.store_dtype)
        print(f"[serve-ann] base {args.base_placement}-resident "
              f"({args.store_dtype}): {store.nbytes / 2**20:.1f} MiB "
              f"off-device; device keeps codes + adjacency")
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
    batch = args.batch or 64
    warm = torch.from_numpy(numpy_queries(d, batch, 1, args.seed + 99)[0]).to(device)
    serve_batches(searcher, spec, [warm], [batch_seed(args.seed, -1)],
                  args.stream_tile)

    if args.serve:
        out, served = serve_open_loop(searcher, spec, args, _fold(args.seed, 7))
        summary = {"n": n, "d": d, "device": str(device), "scorer": args.scorer,
                   "entry": args.entry, "term": args.term, "restarts": args.restarts,
                   "base_placement": args.base_placement,
                   "store_dtype": args.store_dtype, "serve": out}
        return ServeRun(summary=summary, searcher=searcher, build=result, spec=spec,
                        stream=[], seeds=[], results=[],
                        ground_truth=torch.from_numpy(served.ground_truth),
                        served=served)

    stream = [torch.from_numpy(q).to(device)
              for q in numpy_queries(d, batch, args.batches, args.seed)]
    seeds = [batch_seed(args.seed, b) for b in range(args.batches)]
    _sync(device)
    results, dt = serve_batches(searcher, spec, stream, seeds, args.stream_tile)

    # recall/comps over the served traffic; ground truth off the timed path
    all_q = torch.cat(stream)
    gt = ground_truth(all_q, searcher.base, args.topk, searcher.metric)
    served = all_q.shape[0]
    out = {"n": n, "d": d, "device": str(device), "scorer": args.scorer,
           "entry": args.entry, "term": args.term, "restarts": args.restarts,
           "base_placement": args.base_placement, "store_dtype": args.store_dtype,
           "queries": served, "seconds": dt, "qps": served / dt,
           **summarize(results, gt, args.topk),
           "seed_comps_per_query": seed_comps(searcher, spec, stream, seeds),
           "hnsw_layers": layer_sizes}
    mode = f"stream[{args.stream_tile}]" if args.stream_tile else "batch"
    print(f"[serve-ann] entry={args.entry} scorer={args.scorer} term={args.term} "
          f"restarts={args.restarts} ef={args.ef} "
          f"k={args.topk} mode={mode}: {served} queries in {dt * 1e3:.0f} ms "
          f"({out['qps']:.0f} qps), recall@1={out['recall@1']:.3f}, "
          f"recall@{args.topk}={out[f'recall@{args.topk}']:.3f}, "
          f"comps/query={out['comps_per_query']:.0f} "
          f"(seed phase {out['seed_comps_per_query']:.1f}), "
          f"bytes/query={out['bytes_per_query']:.0f}")
    if store is not None:
        out["tier_gathered_rows"] = store.gathered_rows
        out["tier_gathered_bytes"] = store.gathered_bytes
        print(f"[serve-ann] {args.base_placement} tier: "
              f"{store.gathered_bytes / max(served, 1) / 1024:.1f} KiB "
              f"gathered/query ({store.gathered_rows} rerank rows "
              f"total) vs {store.nbytes / 2**20:.1f} MiB base kept "
              f"off-device")
    return ServeRun(summary=out, searcher=searcher, build=result, spec=spec,
                    stream=stream, seeds=seeds, results=results,
                    ground_truth=gt)


class LMServeRun(NamedTuple):
    """What one :func:`serve_lm` run decoded and how long it took."""

    tokens: torch.Tensor     # (batch, steps) greedy tokens, in decode order
    seconds: float
    tok_per_s: float
    ms_per_token: float      # wall per decode step (one token per sequence)


def serve_lm(model: tf.Transformer, batch: int, tokens: int, max_len: int) -> LMServeRun:
    """Greedy decoding as the reference's serve loop: ``tokens`` steps for
    ``batch`` sequences from token 0 at positions 0..tokens-1, each step's
    argmax (ties to the first index) fed to the next. The timer covers the
    steps; the device is synchronised before it stops."""
    cfg = model.cfg
    if tokens < 1:
        raise ValueError(f"--tokens must be >= 1, got {tokens}")
    if tokens > max_len and any(cfg.layer_window(i) is None for i in range(cfg.n_layers)):
        raise ValueError(f"--tokens {tokens} exceeds --max-len {max_len}")
    device = model.device
    caches = tf.init_cache(cfg, batch, max_len, device)
    tok = torch.zeros((batch,), dtype=torch.long, device=device)
    out = []
    _sync(device)
    t0 = time.perf_counter()
    for t in range(tokens):
        pos = torch.full((batch,), t, dtype=torch.int32, device=device)
        tok = torch.argmax(tf.decode_step(model, tok, pos, caches), dim=-1)
        out.append(tok)
    _sync(device)
    dt = time.perf_counter() - t0
    run = LMServeRun(tokens=torch.stack(out, 1), seconds=dt,
                     tok_per_s=tokens * batch / dt, ms_per_token=dt * 1e3 / tokens)
    print(f"[serve] {tokens} tokens x {batch} seqs in {dt:.2f}s "
          f"({run.tok_per_s:.1f} tok/s, {run.ms_per_token:.2f} ms/token) on {device}")
    return run


def serve_lm_arch(args) -> LMServeRun:
    """``--arch`` an LM: init from ``--seed`` on ``--device``, then
    :func:`serve_lm`."""
    arch = configs.get_arch(args.arch)
    cfg = arch.smoke_cfg if args.smoke else arch.model_cfg
    model = tf.init_params(cfg, args.seed, resolve_device(args.device))
    return serve_lm(model, args.batch or 2, args.tokens, args.max_len)


class RetrievalRun(NamedTuple):
    """What one :func:`serve_retrieval` run made: the printed figures
    (``summary``) and the objects behind them."""

    summary: dict
    items: torch.Tensor
    queries: torch.Tensor
    exact: tuple              # (dists, ids) of the exact top RETRIEVAL_K
    knn: object               # NN-Descent's k-NN graph, before GD
    graph: object             # the GD graph (core.graph_index.KnnGraph)
    ann: object               # the beam's SearchResult


def serve_retrieval(args) -> RetrievalRun:
    """``--arch`` a recsys or GNN arch: the reference's retrieval branch
    (module docstring) on ``--device``. Each timed part ends with the
    device synchronised."""
    dev = resolve_device(args.device)
    n, d = SMOKE_WORLD if args.smoke else FULL_WORLD
    items = torch.from_numpy(numpy_world(n, d, args.seed)).to(dev)
    queries = torch.from_numpy(numpy_queries(d, args.batch or 2, 1, args.seed)[0]).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    exact = recsys.retrieval_score_exact(queries, items, k=RETRIEVAL_K)
    _sync(dev)
    exact_ms = (time.perf_counter() - t0) * 1e3
    print(f"[serve] exact retrieval over {n}: {exact_ms:.1f} ms")
    t0 = time.perf_counter()
    knn = build_knn_graph(items, RETRIEVAL_KNN, metric="ip", seed=args.seed)
    gd = build_gd_graph(items, knn, metric="ip")
    _sync(dev)
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    res = recsys.retrieval_score_ann(queries, items, gd.neighbors, k=RETRIEVAL_K,
                                     ef=RETRIEVAL_EF, generator=gen)
    _sync(dev)
    ann_ms = (time.perf_counter() - t0) * 1e3
    out = {"arch": args.arch, "n": n, "d": d, "queries": queries.shape[0],
           "exact_ms": exact_ms, "build_s": build_s, "ann_ms": ann_ms,
           **summarize([res], exact[1], RETRIEVAL_K)}
    print(f"[serve] ANN retrieval: {ann_ms:.1f} ms recall@1={out['recall@1']:.3f} "
          f"(recall@{RETRIEVAL_K}={out[f'recall@{RETRIEVAL_K}']:.3f}, comps/query="
          f"{out['comps_per_query']:.1f}; NN-Descent + GD under ip {build_s:.2f} s) on {dev}")
    return RetrievalRun(summary=out, items=items, queries=queries, exact=exact, knn=knn,
                        graph=gd, ann=res)


def _arch(name: str) -> str:
    if name == "ann" or name in configs.list_archs():
        return name
    raise argparse.ArgumentTypeError(
        f"{name!r} is not an arch of the port: ann or one of "
        f"{', '.join(configs.list_archs())}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, type=_arch,
                    help=f"ann; an LM: {', '.join(configs.list_archs('lm'))}; or a "
                         f"recsys / GNN arch (item retrieval under ip): "
                         f"{', '.join(configs.list_archs('recsys') + configs.list_archs('gnn'))}")
    ap.add_argument("--smoke", action="store_true",
                    help="[ann, retrieval] n=20_000, d=32 world instead of "
                         "n=1_000_000, d=64; [lm] the arch's reduced config "
                         "(deepseek-v3-671b needs it on one card: its full config "
                         "is 671.7e9 parameters, ~1.25 TiB in bf16)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the world, the build and the random entries "
                         "[ann, retrieval], the weights [lm]")
    ap.add_argument("--batch", type=int, default=None,
                    help="queries per batch [ann, default 64], sequences [lm, "
                         "default 2], queries [retrieval, default 2]")
    ap.add_argument("--tokens", type=int, default=32, help="[lm] decode steps")
    ap.add_argument("--max-len", type=int, default=128, help="[lm] cache length")
    ap.add_argument("--ef", type=int, default=64, help="beam width")
    ap.add_argument("--topk", type=int, default=10, help="answers per query")
    ap.add_argument("--batches", type=int, default=8, help="batches to serve")
    ap.add_argument("--build-k", type=int, default=20,
                    help="raw k-NN degree out of NN-Descent")
    ap.add_argument("--build-rounds", type=int, default=15,
                    help="NN-Descent round budget")
    ap.add_argument("--entry", default="random",
                    choices=["random", "projection", "hierarchy", "lsh", "hubs"],
                    help="[ann] entry strategy: where the beam starts")
    ap.add_argument("--term", default="fixed", choices=["fixed", "stable"],
                    help="[ann] per-query termination: fixed = the classic rule; "
                         "stable = also freeze a row once its top-k stops "
                         "improving for --stable-steps steps")
    ap.add_argument("--stable-steps", type=int, default=8,
                    help="[ann] --term stable patience window (steps)")
    ap.add_argument("--restarts", type=int, default=0,
                    help="[ann] fresh-seed restarts per converged query "
                         "(comps charged to the query)")
    ap.add_argument("--build-construct", default="auto",
                    choices=["auto", "nndescent", "exact", "hnsw", "incremental"],
                    help="[ann] construct stage (auto = hnsw for --entry "
                         "hierarchy, else nndescent; incremental = streaming "
                         "inserts through core.mutable.MutableIndex)")
    ap.add_argument("--diversify", default=None, choices=["none", "gd", "dpg"],
                    help="[ann] diversify stage (default: gd; none for hnsw)")
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
    ap.add_argument("--index", default=None,
                    help="[ann] index-artifact .npz to load (or save after "
                         "build); flat, hierarchical and PQ state all "
                         "round-trip (core/io.py)")
    ap.add_argument("--save-index", default=None,
                    help="[ann] write the built artifact here (defaults to "
                         "--index when that file does not exist yet)")
    ap.add_argument("--base-placement", default="device",
                    choices=["device", "host", "disk"],
                    help="[ann] where the float base lives: host/disk keep "
                         "only compressed codes + adjacency on device and "
                         "gather rerank rows from the tier (needs --scorer pq "
                         "or sq8)")
    ap.add_argument("--store-dtype", default="f32", choices=["f32", "bf16"],
                    help="[ann] residual storage dtype for host/disk tiers "
                         "(bf16 = half the rerank bandwidth)")
    ap.add_argument("--serve", action="store_true",
                    help="[ann] open-loop serving: ragged Poisson request "
                         "traffic through the continuous-batching server "
                         "instead of --batch x --batches blocks")
    ap.add_argument("--serve-qps", type=float, default=500.0,
                    help="[ann] offered load for --serve, query rows/s")
    ap.add_argument("--serve-requests", type=int, default=200,
                    help="[ann] requests in the offered stream")
    ap.add_argument("--serve-buckets", default="1,2,4,8,16",
                    help="[ann] sorted batch-size buckets; requests pad to "
                         "the smallest that fits")
    ap.add_argument("--request-sizes", default="1,2,3,4,6,8",
                    help="[ann] ragged request sizes drawn by the load generator")
    ap.add_argument("--max-live-batches", type=int, default=4,
                    help="[ann] admission cap: batches in flight at once")
    ap.add_argument("--queue-depth", type=int, default=16,
                    help="[ann] backlog bound; submits past it are shed")
    ap.add_argument("--serve-mutate", type=int, default=0,
                    help="[ann] under --serve: after the first stream, insert "
                         "this many points and tombstone half as many through "
                         "MutableIndex, hot-swap the mutated index into the "
                         "live server (warmed before the flip), then serve a "
                         "second stream")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.serve and args.arch != "ann":
        raise SystemExit("--serve is an --arch ann mode")
    if args.serve and args.stream_tile:
        raise SystemExit("--serve buckets requests itself; drop --stream-tile")
    if args.arch == "ann":
        return serve_ann(args)
    if configs.get_arch(args.arch).family == "lm":
        return serve_lm_arch(args)
    return serve_retrieval(args)


if __name__ == "__main__":
    main()
