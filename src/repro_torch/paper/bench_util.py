"""Shared plumbing of the paper's experiment: timers, the world of indexes
one dataset needs, the speedup metric (``benchmarks/bench_util.py``)."""
from __future__ import annotations

import time

import torch

from ..core import bruteforce, diversify, hnsw, nndescent
from ..core.engine import Searcher
from ..core.graph_index import HnswIndex, memory_bytes


def _sync(device: torch.device | None) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, *args, warmup: int = 1, iters: int = 3,
           device: torch.device | None = None) -> tuple[float, object]:
    """(mean wall seconds of ``iters`` calls after ``warmup``, last output);
    on a CUDA ``device`` the device is synchronised before the clock starts
    and after each call."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
        _sync(device)
    return (time.perf_counter() - t0) / iters, out


class _Stage:
    """Wall seconds and (on a GPU) peak device memory of one build stage,
    into ``world.build_s`` / ``world.peak_bytes``."""

    def __init__(self, world: "AnnWorld", name: str):
        self.world, self.name = world, name

    def __enter__(self):
        if self.world.device.type == "cuda":
            torch.cuda.synchronize(self.world.device)
            torch.cuda.reset_peak_memory_stats(self.world.device)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dev = self.world.device
        _sync(dev)
        self.world.build_s[self.name] = time.perf_counter() - self.t0
        if dev.type == "cuda":
            self.world.peak_bytes[self.name] = int(torch.cuda.max_memory_allocated(dev))


class AnnWorld:
    """One dataset + every index the experiments need, built once on the
    base's device: ground truth and the exhaustive time, the KGraph
    (NN-Descent, k = ``k_graph``), its GD and DPG diversifications, and HNSW
    (M = max(8, k/2), brute_threshold 2048) over the KGraph as its bottom
    layer. ``kgraph`` injects the KGraph (the tests hand it the
    reference's); ``seed`` seeds NN-Descent, the HNSW levels and every
    search's entries."""

    def __init__(self, base, queries, metric="l2", k_graph=20, seed=0, kgraph=None):
        self.base = base.float().contiguous()
        self.queries = queries.float().contiguous()
        self.metric, self.seed = metric, seed
        self.device = self.base.device
        self.n = base.shape[0]
        self.build_s: dict[str, float] = {}
        self.peak_bytes: dict[str, int] = {}
        with _Stage(self, "ground_truth"):
            self.gt = bruteforce.ground_truth(self.queries, self.base, 1, metric)
        self.exh_time, _ = timeit(
            lambda: bruteforce.exact_search(self.queries, self.base, 1, metric),
            iters=2, device=self.device)
        if kgraph is None:
            with _Stage(self, "kgraph"):
                kgraph = nndescent.build_knn_graph(
                    self.base, nndescent.NNDescentConfig(k=k_graph), metric=metric,
                    seed=seed)
        self.kgraph = kgraph
        with _Stage(self, "gd"):
            self.gd = diversify.build_gd_graph(self.base, kgraph, metric=metric)
        with _Stage(self, "dpg"):
            self.dpg = diversify.build_dpg_graph(self.base, kgraph)
        with _Stage(self, "hnsw"):
            self.hnsw = hnsw.build_hnsw(
                self.base,
                hnsw.HnswConfig(M=max(8, k_graph // 2), knn_k=k_graph,
                                brute_threshold=2048),
                metric=metric, seed=seed, bottom_graph=kgraph)
        self._searchers = {}

    def index_bytes(self) -> dict[str, int]:
        """Adjacency bytes of each index (HNSW: every layer's)."""
        return {"kgraph": memory_bytes(self.kgraph.neighbors),
                "gd": memory_bytes(self.gd.neighbors),
                "dpg": memory_bytes(self.dpg.neighbors),
                "hnsw": memory_bytes(self.hnsw.layers_neighbors)}

    def searcher_for(self, graph_or_index) -> Searcher:
        """Engine view of any index this world built (one per graph, cached)."""
        sid = id(graph_or_index)
        if sid not in self._searchers:
            if isinstance(graph_or_index, HnswIndex):
                s = Searcher.from_hnsw(self.base, graph_or_index, metric=self.metric,
                                       rng_seed=self.seed)
            else:
                s = Searcher.from_graph(self.base, graph_or_index, metric=self.metric,
                                        rng_seed=self.seed)
            # keep the graph alive alongside its Searcher: the cache key is
            # id(), which CPython may reuse once the object is collected
            self._searchers[sid] = (graph_or_index, s)
        return self._searchers[sid][1]

    def recall_curve(self, graph_or_index, efs=(8, 16, 32, 64, 128), entry="random",
                     entries: dict | None = None):
        """[(ef, recall@1, mean comps, wall time, speedup_time, speedup_comps)]

        Every method routes through the engine; ``entry`` picks the seeding
        strategy (random = flat-HNSW, hierarchy = HNSW, ...). Seeds are
        drawn OUTSIDE the timed call, so ``wall`` times the beam core only;
        the ``comps`` column still charges the seed phase. ``entries`` maps
        ef to (entry ids, seed-phase comps) in place of the draw."""
        rows = []
        q = self.queries
        searcher = self.searcher_for(graph_or_index)
        for ef in efs:
            spec = searcher.spec(ef=ef, k=1, entry=entry, n_entries=min(8, ef))
            if entries is None:
                ent, extra = searcher.seed(q, spec, seed=self.seed)
            else:
                ent, extra = entries[ef]
            wall, res = timeit(lambda: searcher.search(q, spec, entries=ent,
                                                       entry_comps=extra),
                               iters=2, device=self.device)
            recall = float((res.ids[:, 0] == self.gt[:, 0]).float().mean())
            comps = float(res.n_comps.float().mean())
            rows.append(dict(ef=ef, recall=recall, comps=comps, wall=wall,
                             speedup_time=self.exh_time / max(wall, 1e-9),
                             speedup_comps=self.n / max(comps, 1.0)))
        return rows

    def summary_line(self, name: str) -> str:
        """Build seconds, peak device GiB (on a GPU) and index bytes."""
        peak = {k: round(v / 2**30, 2) for k, v in self.peak_bytes.items()}
        secs = {k: round(v, 3) for k, v in self.build_s.items()}
        return (f"# world {name}: n={self.n} d={self.base.shape[1]} build_s={secs} "
                f"peak_gib={peak} exh_time={self.exh_time:.6f} "
                f"index_bytes={self.index_bytes()}")


def speedup_at_recall(rows, target):
    """Paper Fig. 3 metric: best speedup among settings reaching the target."""
    ok = [r for r in rows if r["recall"] >= target]
    if not ok:
        return None
    return max(ok, key=lambda r: r["speedup_comps"])
