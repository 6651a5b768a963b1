"""Paper Fig. 4: HNSW vs flat-HNSW (same bottom layer, random seeds) across
dimensionality (claim C2: hierarchy helps at d<=8, fades by d~32), plus the
hub-seeded flat column on the SAME bottom layer (the claim that hubs, not
layers, do the hierarchy's work), as ``benchmarks/fig4_hierarchy.py``."""
from __future__ import annotations

from .bench_util import AnnWorld


def run(world: AnnWorld, name: str, out=print):
    hier = world.recall_curve(world.hnsw, entry="hierarchy")
    flat = world.recall_curve(world.hnsw, entry="random")
    hubs = world.recall_curve(world.hnsw, entry="hubs")
    for h, f, u in zip(hier, flat, hubs):
        out(
            f"fig4/{name}/ef={h['ef']},hnsw_recall={h['recall']:.3f},"
            f"hnsw_comps={h['comps']:.0f},flat_recall={f['recall']:.3f},"
            f"flat_comps={f['comps']:.0f},hubs_recall={u['recall']:.3f},"
            f"hubs_comps={u['comps']:.0f}"
        )
    return {"hnsw": hier, "flat": flat, "hubs": hubs}
