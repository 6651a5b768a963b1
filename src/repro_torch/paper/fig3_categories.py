"""Paper Fig. 3: graph-based methods vs tree/LSH/PQ baselines — speedup at
recall 0.8 / 0.9 (claim C1: graph methods dominate), as
``benchmarks/fig3_categories.py``."""
from __future__ import annotations

from ..baselines import lsh, pq, tree
from .bench_util import AnnWorld, speedup_at_recall, timeit


def _baseline_rows(world: AnnWorld, build_fn, search_fn, params):
    idx = build_fn(world.base)
    rows = []
    for p in params:
        wall, (_, ids, comps) = timeit(
            lambda p=p: search_fn(world.queries, world.base, idx, p), iters=2,
            device=world.device)
        mean_comps = float(comps.float().mean())
        rows.append(dict(
            param=p,
            recall=float((ids[:, 0] == world.gt[:, 0]).float().mean()),
            comps=mean_comps,
            wall=wall,
            speedup_time=world.exh_time / max(wall, 1e-9),
            speedup_comps=world.n / max(mean_comps, 1.0),
        ))
    return rows


def run(world: AnnWorld, name: str, out=print):
    methods = {
        "KGraph": world.recall_curve(world.kgraph),
        "KGraph+GD": world.recall_curve(world.gd),
        "DPG": world.recall_curve(world.dpg),
        "HNSW": world.recall_curve(world.hnsw, entry="hierarchy"),
        "PQ": _baseline_rows(
            world,
            lambda b: pq.build_pq(b, M=8 if b.shape[1] % 8 == 0 else 4, iters=10),
            lambda q, b, i, p: pq.pq_search(q, b, i, k=1, rerank=p),
            (32, 128, 512),
        ),
        "SRS": _baseline_rows(
            world,
            lambda b: lsh.build_srs(b, m=8),
            lambda q, b, i, p: lsh.srs_search(q, b, i, k=1, probes=p),
            (128, 512, 2048),
        ),
        "Annoy(RP-forest)": _baseline_rows(
            world,
            lambda b: tree.build_forest(b, n_trees=12),
            lambda q, b, i, p: tree.forest_search(q, b, i, k=1),
            (0,),
        ),
    }
    results = {}
    for m, rows in methods.items():
        for target in (0.8, 0.9):
            best = speedup_at_recall(rows, target)
            sp = f"{best['speedup_comps']:.1f}" if best else "-"
            st = f"{best['speedup_time']:.1f}" if best else "-"
            out(f"fig3/{name}/{m}@{target},speedup_comps={sp},speedup_time={st}")
            results[(m, target)] = best
    return results
