"""Paper Fig. 6: comparisons spent per distance range reached, the
curse-of-dimensionality anatomy (claim C4: high-d search spends nearly all
comparisons in the 'close neighborhood'), as
``benchmarks/fig6_comparisons.py``.

Each method is (entry strategy x graph) through the engine; the traced
beam core is identical, so the figure isolates how the starting point
shifts where comparisons are spent.
"""
from __future__ import annotations

import numpy as np

from ..core.distances import report_scale
from .bench_util import AnnWorld


def run(world: AnnWorld, name: str, n_queries: int = 50, ef: int = 64, out=print):
    q = world.queries[:n_queries]
    rows = {}
    methods = {
        "HNSW": (world.hnsw, "hierarchy"),
        "flat-HNSW": (world.hnsw, "random"),
        "KGraph+GD": (world.gd, "random"),
    }
    for method, (graph, entry) in methods.items():
        searcher = world.searcher_for(graph)
        spec = searcher.spec(ef=ef, k=1, entry=entry, n_entries=8)
        _, td, tc = searcher.search_with_trace(q, spec, seed=world.seed, max_steps=3 * ef)
        td = report_scale(td, world.metric).cpu().numpy()   # (steps, Q)
        tc = tc.cpu().numpy().astype(np.float64)
        # histogram: comparisons spent while best-distance is in each range
        edges = np.quantile(td[np.isfinite(td)], [1.0, 0.75, 0.5, 0.25, 0.1, 0.0])
        spent = []
        dcomps = np.diff(tc, axis=0, prepend=tc[:1])
        for i in range(len(edges) - 1):
            hi, lo = edges[i], edges[i + 1]
            in_range = (td <= hi) & (td >= lo)
            spent.append(float((dcomps * in_range).sum() / q.shape[0]))
        rows[method] = dict(edges=edges.tolist(), spent=spent)
        out(
            f"fig6/{name}/{method},range_edges={np.round(edges, 4).tolist()},"
            f"comps_per_range={np.round(spent, 1).tolist()}"
        )
    return rows
