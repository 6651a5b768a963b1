"""Traffic driver ``index_builds``: whole index builds back to back,
``GraphBuilder(config's index).build(base, seed)``, over the seed's base.

Build i takes the seed ``(seed, "build", i)``; set-up makes one build of
its own (index -1) at the same shape. Parameters (the cell's ``params``):
``trace_builds`` (builds in the profiled window of a ``--trace 1`` run) and
under ``check`` ``graph_sample`` (vertices a graph's rows are judged on). Every graph built, in the window and in the traced
window, is judged after the window closes: every row against the
adjacency's invariants, the sampled rows against the reference's exact
neighbours and float64 GD, and the distances the build's NN-Descent stage
kept for the sampled rows' edges against float64. Each reading is the worst
graph's.
"""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from annbench.reference import check as ref_check
from annbench.reference.data import make_world, substream
from annbench.reference.graph import bad_entries
from annbench.traffic.search_batches import build_spec

WARMUP_INDEX = -1


class Driver:
    kind = "build"

    def __init__(self, config: dict, params: dict, seed: int, device):
        self.cfg, self.p, self.seed = config, params, seed
        self.dev = torch.device(device)
        self.graphs = []           # (build index, neighbors, NN-Descent graph) of every build
        self._stage = None

    def make_data(self) -> None:
        data = self.cfg["data"]
        self.world = make_world(self.seed, data["n"], data["d"], data["latent"],
                                data["data_seed"], self.dev)

    def setup(self) -> None:
        from repro_torch.core.build import GraphBuilder

        self.make_data()
        self.builder = GraphBuilder(build_spec(self.cfg["index"]))
        self._keep_construct()
        self._build(WARMUP_INDEX, keep=False)

    def _keep_construct(self) -> None:
        """Hold on to each build's construct-stage graph: the GD graph that
        a build returns carries no distances, NN-Descent's does."""
        construct = self.builder._construct

        def kept(*args, **kwargs):
            cres = construct(*args, **kwargs)
            self._stage = cres.graph
            return cres
        self.builder._construct = kept

    def _build(self, i: int, keep: bool = True):
        with record_function("annbench.GraphBuilder.build"):
            result = self.builder.build(self.world.base, seed=substream(self.seed, "build", i))
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
        if keep:
            self.graphs.append((i, result.graph.neighbors, self._stage))
        self._stage = None
        return result.report

    def _loop(self, first: int, until):
        b = {"count": 0, "construct_s": [], "diversify_s": [], "total_s": []}
        while until(b["count"]):
            rep = self._build(first + b["count"])
            b["count"] += 1
            b["construct_s"].append(rep.wall_construct_s)
            b["diversify_s"].append(rep.wall_diversify_s)
            b["total_s"].append(rep.wall_total_s)
        return b

    def window(self, seconds: float, obs: dict) -> None:
        t0 = time.perf_counter()
        b = self._loop(len(self.graphs), lambda c: c == 0 or time.perf_counter() - t0 < seconds)
        obs["window_s"] = time.perf_counter() - t0
        obs["builds"] = b
        obs["attempted"] = b["count"]
        obs["e2e"] = {"build_s": obs["window_s"] / b["count"]}
        obs["detail"] = f"builds' walls {b['total_s']}"

    def traced(self, profile) -> dict:
        """The profiled window: ``trace_builds`` more builds."""
        first = len(self.graphs)
        k = self.p["trace_builds"]
        b, tl = profile(lambda attempt: self._loop(first + attempt * k, lambda c: c < k))
        return {"timeline": tl, "build": b}

    def release(self) -> None:
        del self.builder
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self, i: int) -> torch.Tensor:
        return ref_check.sample_vertices(self.world.base.shape[0],
                                         self.p["check"]["graph_sample"],
                                         substream(self.seed, "graph_sample", i), self.dev)

    def _keep(self):
        L = self.cfg["index"]["graph_k"]
        return L, self.cfg["index"].get("max_keep") or L // 2

    def check(self, obs: dict) -> dict:
        base = self.world.base
        L, keep = self._keep()
        out: dict = {}
        failed = 0
        for i, nbrs, stage in self.graphs:
            v = self._sample(i)
            r = ref_check.judge_rows(base, v, nbrs[v], L, keep)
            r["edge_dist_err"] = (float("inf") if stage is None else
                                  ref_check.edge_dist_err(base, v, stage.neighbors[v],
                                                          stage.dists[v]))
            r["bad_entries"] = bad_entries(nbrs, base.shape[0])
            failed += r["bad_entries"] > 0
            for name, value in r.items():
                out[name] = max(out.get(name, value), value)
        obs["failed"] = failed
        return out

    def control(self, builds: int) -> dict:
        """Readings of the controls in the program's place, on this seed's
        base (``make_data``; no build runs), on the rows build 0's check
        samples: the precision control (TF32 nearest lists with their TF32
        distances, and TF32 GD) and the guarantee control (the same, the
        vertex left among its own nearest)."""
        base = self.world.base
        L, keep = self._keep()
        v = self._sample(0)
        out = {}
        for name, keep_self in (("precision", False), ("guarantee", True)):
            dists, cand = ref_check.control_edges(base, v, L, keep_self=keep_self)
            rows = ref_check.control_rows(base, v, L, keep, keep_self=keep_self, cand=cand)
            out[name] = ref_check.judge_rows(base, v, rows, L, keep)
            out[name]["edge_dist_err"] = ref_check.edge_dist_err(base, v, cand, dists)
            out[name]["bad_entries"] = bad_entries(rows, base.shape[0], rows=v)
        return out
