"""Traffic driver ``search_batches``: one closed-loop client sends batches of
fresh query rows to ``Searcher.search`` over an index built in set-up.

Parameters (the cell's ``params``): ``batch_rows`` (rows a batch), ``ef``,
``k``, ``entry``, ``n_entries``, ``scorer`` (the ``SearchSpec``),
``trace_batches`` (batches in the profiled window of a ``--trace 1`` run),
and under ``check`` ``recall_sample`` (window rows whose recall the
reference measures) and ``graph_sample`` (vertices whose rows it judges). The index is the configuration's ``index``
(``BuildSpec``), built from the seed's base with a seed drawn from it.

Batch i's rows are ``reference.data.query_batch(world, i)``, drawn afresh
each batch from the base's lift; its search seed is ``(seed, "search", i)``.
Every answer of every batch, in the window and in the traced window, is
judged after the window closes; recall, which needs the exact neighbours, on
a sample of the window's rows drawn from the seed.
"""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from annbench.reference import check as ref_check
from annbench.reference.data import make_world, query_batch, substream
from annbench.reference.graph import bad_entries

WARMUP_INDEX = -1


def build_spec(index: dict):
    from repro_torch.core.build import BuildSpec

    return BuildSpec(**index)


class Driver:
    kind = "search"

    def __init__(self, config: dict, params: dict, seed: int, device):
        self.cfg, self.p, self.seed = config, params, seed
        self.dev = torch.device(device)
        self.answers = []          # (batch index, ids, dists) of every batch answered

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def make_data(self) -> None:
        data = self.cfg["data"]
        self.world = make_world(self.seed, data["n"], data["d"], data["latent"],
                                data["data_seed"], self.dev)

    def setup(self) -> None:
        from repro_torch.core.build import GraphBuilder
        from repro_torch.core.engine import Searcher

        self.make_data()
        result = GraphBuilder(build_spec(self.cfg["index"])).build(
            self.world.base, seed=substream(self.seed, "build"))
        self.searcher = Searcher.from_build(self.world.base, result,
                                            rng_seed=substream(self.seed, "searcher"))
        p = self.p
        self.spec = self.searcher.spec(ef=p["ef"], k=p["k"], entry=p["entry"],
                                       n_entries=p["n_entries"], scorer=p["scorer"])
        # the cell's one shape, from a stream no judged batch uses
        self._batch(WARMUP_INDEX, keep=False)

    def _batch(self, i: int, keep: bool = True):
        with record_function("annbench.draw_queries"):
            q = query_batch(self.world, i, self.p["batch_rows"])
        self._sync()
        t = time.perf_counter()
        with record_function("annbench.Searcher.search"):
            res = self.searcher.search(q, self.spec, seed=substream(self.seed, "search", i))
            self._sync()
        wall = time.perf_counter() - t
        if keep:
            self.answers.append((i, res.ids, res.dists))
        return res, wall

    def _loop(self, first: int, until):
        """Batches first, first + 1, ... while ``until(batches done)``;
        their counters."""
        s = {"batches": 0, "rows": 0, "steps": [], "comps": 0, "wall_s": 0.0, "walls": []}
        comps = torch.zeros((), dtype=torch.int64, device=self.dev)
        while until(s["batches"]):
            res, wall = self._batch(first + s["batches"])
            s["batches"] += 1
            s["rows"] += res.ids.shape[0]
            s["steps"].append(int(res.n_steps))
            s["wall_s"] += wall
            s["walls"].append(round(wall, 4))
            comps += res.n_comps.sum()
        s["comps"] = int(comps)
        return s

    def window(self, seconds: float, obs: dict) -> None:
        t0 = time.perf_counter()
        s = self._loop(len(self.answers), lambda b: b == 0 or time.perf_counter() - t0 < seconds)
        obs["window_s"] = time.perf_counter() - t0
        obs["search"] = s
        obs["attempted"] = s["rows"]
        obs["e2e"] = {"qps": s["rows"] / obs["window_s"]}
        obs["detail"] = f"steps a batch {s['steps']}; walls {s['walls']}"

    def traced(self, profile) -> dict:
        """The profiled window: ``trace_batches`` more batches."""
        first = len(self.answers)
        p = self.p

        def run(attempt):
            start = first + attempt * p["trace_batches"]
            return self._loop(start, lambda b: b < p["trace_batches"])

        s, tl = profile(run)
        s.update(R=int(self.searcher.neighbors.shape[1]), E=self.spec.num_seeds,
                 d=int(self.world.base.shape[1]))
        return {"timeline": tl, "search": s}

    def release(self) -> None:
        """Free the program's state: only the searched graph and the answers
        stay for the check."""
        self.graph = self.searcher.neighbors
        del self.searcher
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _graph_readings(self, rows_of) -> dict:
        c = self.p["check"]
        base = self.world.base
        vertices = ref_check.sample_vertices(base.shape[0], c["graph_sample"],
                                             substream(self.seed, "graph_sample"), self.dev)
        L = self.cfg["index"]["graph_k"]
        keep = self.cfg["index"].get("max_keep") or L // 2
        rows = rows_of(vertices, L, keep)
        out = ref_check.judge_rows(base, vertices, rows, L, keep)
        out["bad_entries"] = bad_entries(rows, base.shape[0], rows=vertices)
        return out

    def _recall_rows(self, batches: int, rows: int) -> list:
        """Each of the window's batches' rows in the recall sample: ``recall_sample``
        rows of the window's answers drawn from the seed."""
        gen = torch.Generator().manual_seed(substream(self.seed, "recall_sample"))
        pick = torch.randperm(batches * rows, generator=gen)[:self.p["check"]["recall_sample"]]
        return [torch.sort(pick[(pick >= b * rows) & (pick < (b + 1) * rows)] - b * rows).values
                for b in range(batches)]

    def check(self, obs: dict) -> dict:
        """Readings of every answer (recall on the sample) and of the
        searched graph."""
        base, k, rows = self.world.base, self.p["k"], self.p["batch_rows"]
        judge = ref_check.AnswerJudge(base, k)
        n_window = obs["search"]["batches"]
        sample = self._recall_rows(n_window, rows)
        for j, (i, ids, dists) in enumerate(self.answers):
            pick = sample[j] if j < n_window else sample[0][:0]
            judge.add(query_batch(self.world, i, rows), ids, dists, recall_rows=pick)
        out = judge.readings()
        obs["e2e"]["recall_at_10"] = out["recall_at_10"]
        obs["failed"] = out["bad_answers"]
        out.update(self._graph_readings(lambda v, L, keep: self.graph[v]))
        out["bad_entries"] = bad_entries(self.graph, base.shape[0])   # every row
        return out

    def control(self, batches: int) -> dict:
        """Readings of the precision control in the program's place, on this
        seed's base (``make_data``; no index is built): TF32 brute-force
        answers to batches 0 .. batches - 1 and TF32 GD rows."""
        base, k = self.world.base, self.p["k"]
        judge = ref_check.AnswerJudge(base, k)
        sample = self._recall_rows(batches, self.p["batch_rows"])
        for i in range(batches):
            q = query_batch(self.world, i, self.p["batch_rows"])
            ids, dists = ref_check.control_answers(base, q, k)
            judge.add(q, ids, dists, recall_rows=sample[i])
        out = judge.readings()
        out.update(self._graph_readings(
            lambda v, L, keep: ref_check.control_rows(base, v, L, keep)))
        return {"precision": out}
