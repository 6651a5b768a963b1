"""Recall of the JAX reference on the port's smoke world, on the CPU.

Builds the paper's index with ``repro`` (NN-Descent, graph_k=20, 15 rounds,
GD; plus PQ codes, M=8, K=256, under ``--scorer pq``; HNSW with no
diversify stage under ``--entry hierarchy``, as the serve CLI's ``auto``
construct) over the same numpy world the port's ``launch/serve.py --smoke``
and ``chip_smoke.py`` use (n=20_000, d=32, seed 0), answers 8 batches of 64
queries at ef=64, k=10 from ``--entry`` (random by default) under
``--scorer`` (exact, sq8 or pq; rerank all ef), and prints the build's
rounds, update curve and graph-recall proxy, and recall@1, recall@10,
comps/query and bytes/query against brute-force ground truth, as one JSON
line. With ``--port`` it also runs the port on the CPU over the same world;
``--n``, ``--d`` and ``--seed`` pick another world of the same kind.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/reference_smoke_recall.py --port \
        [--scorer sq8|pq] [--entry hierarchy|hubs|projection|lsh]

``--retrieval`` runs the serve CLI's recsys / GNN branch instead (the
reference's ``launch/serve.py`` non-LM branch) on the same world:
NN-Descent under ``ip`` (k=16, 8 rounds), GD under ``ip``, and the beam
(ef=96, k=10) from 16 random entries a query over ``--batch`` queries
(default 512), scored against the exact inner-product top 10; it prints
recall@1, recall@10 and comps/query (and, with ``--port``, the port's
``serve_retrieval`` on the CPU):

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/reference_smoke_recall.py \
        --retrieval --port

``chip_smoke.py`` holds the port on the card to these recall figures less a
slack (its constants ``REF_SMOKE_RECALL10*`` and ``REF_RETRIEVAL_RECALL*``).
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import bruteforce
from repro.core.build import BuildSpec, GraphBuilder
from repro.core.engine import Searcher
from repro.core.topk import recall_at_k
from repro_torch.launch.serve import SMOKE_WORLD, numpy_queries, numpy_world

EF, K, BATCH, BATCHES = 64, 10, 64, 8
# the reference's own retrieval settings (repro/launch/serve.py, its non-LM
# branch: NN-Descent k=16, 8 rounds; the beam at ef=96, k=10), kept apart
# from the port's so that a drift in the port's shows against them
RETRIEVAL_KNN_K, RETRIEVAL_ROUNDS, RETRIEVAL_EF, RETRIEVAL_K = 16, 8, 96, 10


def reference(seed: int, n: int, d: int, scorer: str = "exact",
              entry: str = "random") -> dict:
    base = jnp.asarray(numpy_world(n, d, seed))
    key = jax.random.PRNGKey(seed)
    t0 = time.perf_counter()
    compress = "pq" if scorer == "pq" else "none"
    bspec = (BuildSpec(construct="hnsw", diversify="none", compress=compress)
             if entry == "hierarchy" else BuildSpec(compress=compress))
    result = GraphBuilder(bspec).build(base, key=key)
    build_s = time.perf_counter() - t0
    searcher = Searcher.from_build(base, result, key=key)
    spec = searcher.spec(ef=EF, k=K, scorer=scorer, entry=entry)
    qs = numpy_queries(d, BATCH, BATCHES, seed)
    ids, comps, nbytes = [], [], []
    for b, q in enumerate(qs):
        res = searcher.search(jnp.asarray(q), spec,
                              jax.random.fold_in(key, 1000 + b))
        ids.append(np.asarray(res.ids))
        comps.append(np.asarray(res.n_comps))
        nbytes.append(np.asarray(res.bytes_touched))
    allq = jnp.asarray(np.concatenate(qs))
    gt = np.asarray(bruteforce.ground_truth(allq, base, K))
    found = np.concatenate(ids)
    rep = result.report
    return {
        "impl": "repro (JAX, CPU)", "n": n, "d": d, "seed": seed,
        "scorer": scorer, "entry": entry, "build_s": build_s,
        "hnsw_layers": [layer["nodes"] for layer in rep.layers],
        "rounds": rep.rounds, "update_curve": list(rep.update_curve),
        "graph_recall_proxy": rep.graph_recall_proxy,
        "degree_mean": rep.degree["mean"],
        "recall@1": float((found[:, 0] == gt[:, 0]).mean()),
        "recall@10": float(recall_at_k(jnp.asarray(found), jnp.asarray(gt))),
        "comps_per_query": float(np.concatenate(comps).mean()),
        "bytes_per_query": float(np.concatenate(nbytes).mean()),
    }


def reference_retrieval(seed: int, n: int, d: int, batch: int) -> dict:
    from repro.core import beam_search as jbeam
    from repro.core.diversify import build_gd_graph
    from repro.core.nndescent import NNDescentConfig, build_knn_graph
    from repro.models.recsys import retrieval_score_exact

    items = jnp.asarray(numpy_world(n, d, seed))
    queries = jnp.asarray(numpy_queries(d, batch, 1, seed)[0])
    key = jax.random.PRNGKey(seed)
    _, exact = retrieval_score_exact(queries, items, k=RETRIEVAL_K)
    t0 = time.perf_counter()
    knn = build_knn_graph(items, NNDescentConfig(k=RETRIEVAL_KNN_K, rounds=RETRIEVAL_ROUNDS),
                          metric="ip", key=key)
    gd = build_gd_graph(items, knn, metric="ip")
    jax.block_until_ready(gd.neighbors)
    build_s = time.perf_counter() - t0
    # retrieval_score_ann's own draw and beam, kept whole for n_comps
    entries = jbeam.random_entries(key, n, batch, min(16, RETRIEVAL_EF))
    res = jbeam.beam_search(queries, items, gd.neighbors, entries, ef=RETRIEVAL_EF,
                            k=RETRIEVAL_K, metric="ip")
    found, exact = np.asarray(res.ids), np.asarray(exact)
    return {"impl": "repro (JAX, CPU)", "mode": "retrieval", "n": n, "d": d, "seed": seed,
            "queries": batch, "build_s": build_s,
            "recall@1": float((found[:, 0] == exact[:, 0]).mean()),
            f"recall@{RETRIEVAL_K}": float(recall_at_k(jnp.asarray(found), jnp.asarray(exact))),
            "comps_per_query": float(np.asarray(res.n_comps).mean())}


def port_retrieval(seed: int, n: int, d: int, batch: int) -> dict:
    from repro_torch.launch import serve

    serve.SMOKE_WORLD = (n, d)
    run = serve.serve_retrieval(serve.parser().parse_args(
        ["--arch", "dlrm-mlperf", "--smoke", "--device", "cpu", "--seed", str(seed),
         "--batch", str(batch)]))
    return {"impl": "repro_torch (CPU)", "mode": "retrieval", **run.summary}


def port(seed: int, n: int, d: int, scorer: str = "exact", entry: str = "random") -> dict:
    from repro_torch.launch import serve

    serve.SMOKE_WORLD = (n, d)
    args = serve.parser().parse_args(["--arch", "ann", "--smoke", "--device", "cpu",
                                "--seed", str(seed), "--ef", str(EF),
                                "--topk", str(K), "--batch", str(BATCH),
                                "--batches", str(BATCHES), "--scorer", scorer,
                                "--entry", entry])
    run = serve.serve_ann(args)
    rep = run.build.report
    return {"impl": "repro_torch (CPU)", "rounds": rep.rounds,
            "update_curve": list(rep.update_curve),
            "graph_recall_proxy": rep.graph_recall_proxy,
            "degree_mean": rep.degree["mean"], **run.summary}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=SMOKE_WORLD[0])
    ap.add_argument("--d", type=int, default=SMOKE_WORLD[1])
    ap.add_argument("--scorer", default="exact", choices=["exact", "sq8", "pq"])
    ap.add_argument("--entry", default="random",
                    choices=["random", "projection", "hierarchy", "lsh", "hubs"])
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the CPU over the same world")
    ap.add_argument("--retrieval", action="store_true",
                    help="the recsys / GNN serve branch (ip) instead of the ANN path")
    ap.add_argument("--batch", type=int, default=512, help="[--retrieval] queries")
    args = ap.parse_args()
    if args.retrieval:
        print(json.dumps(reference_retrieval(args.seed, args.n, args.d, args.batch)),
              flush=True)
        if args.port:
            print(json.dumps(port_retrieval(args.seed, args.n, args.d, args.batch)))
        return
    print(json.dumps(reference(args.seed, args.n, args.d, args.scorer, args.entry)),
          flush=True)
    if args.port:
        print(json.dumps(port(args.seed, args.n, args.d, args.scorer, args.entry)))


if __name__ == "__main__":
    main()
