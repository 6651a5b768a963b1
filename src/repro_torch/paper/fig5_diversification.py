"""Paper Fig. 5: KGraph vs KGraph+GD vs DPG vs HNSW on the SAME NN-Descent
graph (claim C3: diversified flat graphs reach HNSW-level performance), as
``benchmarks/fig5_diversification.py``."""
from __future__ import annotations

from .bench_util import AnnWorld


def run(world: AnnWorld, name: str, out=print):
    curves = {
        "KGraph": world.recall_curve(world.kgraph),
        "KGraph+GD": world.recall_curve(world.gd),
        "DPG": world.recall_curve(world.dpg),
        "HNSW": world.recall_curve(world.hnsw, entry="hierarchy"),
    }
    for m, rows in curves.items():
        best = max(rows, key=lambda r: (r["recall"], r["speedup_comps"]))
        out(
            f"fig5/{name}/{m},best_recall={best['recall']:.3f},"
            f"comps={best['comps']:.0f},speedup_comps={best['speedup_comps']:.1f}"
        )
    # index sizes (paper: GD graph is smaller than DPG)
    b = world.index_bytes()
    out(f"fig5/{name}/index_bytes,kgraph={b['kgraph']},gd={b['gd']},dpg={b['dpg']},"
        f"hnsw={b['hnsw']}")
    return curves
