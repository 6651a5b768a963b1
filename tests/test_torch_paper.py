"""The paper's experiment through the port at CI scale, held against live
calls into the reference's ``benchmarks/`` plumbing on the CPU.

Given the reference's KGraph, the port's ``AnnWorld`` builds the same GD
and DPG graphs, and given the same entries its KGraph / GD / DPG recall
curves give the same recall and comps at every ef. Every ``tab1/`` and
``fig*/`` line carries the reference's keys. The reference's end-to-end
floors (``tests/test_system.py``) hold on the port's own data and draws.
"""
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.data import synthetic as jsyn
from repro_torch.core import beam_search, bruteforce, convert, diversify, hnsw, nndescent
from repro_torch.data.synthetic import make_ann_dataset
from repro_torch.paper import (
    bench_util,
    fig3_categories,
    fig4_hierarchy,
    fig5_diversification,
    fig6_comparisons,
    tab1_datasets,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from benchmarks import bench_util as jbench  # noqa: E402
from benchmarks import fig3_categories as jfig3  # noqa: E402
from benchmarks import fig4_hierarchy as jfig4  # noqa: E402
from benchmarks import fig5_diversification as jfig5  # noqa: E402
from benchmarks import fig6_comparisons as jfig6  # noqa: E402
from benchmarks import tab1_datasets as jtab1  # noqa: E402

EFS = (8, 16, 32, 64, 128)


@pytest.fixture(scope="module")
def worlds():
    """The reference's CI-scale SIFT1M world (scale 0.004: n=4000, d=128,
    100 queries, jax.random key 0) and the port's AnnWorld on the same base
    and queries, given the reference's KGraph."""
    base, queries, metric = jsyn.make_ann_dataset("SIFT1M", key=jax.random.PRNGKey(0),
                                                  scale=0.004, n_queries=100)
    ref = jbench.AnnWorld(base, queries, metric=metric)
    kgraph = convert.graph_from_numpy(ref.kgraph.neighbors, ref.kgraph.dists, "cpu")
    port = bench_util.AnnWorld(convert.tensor(base, torch.float32, "cpu"),
                               convert.tensor(queries, torch.float32, "cpu"),
                               metric=metric, kgraph=kgraph)
    return ref, port


def test_world_builds_the_references_graphs(worlds):
    ref, port = worlds
    np.testing.assert_array_equal(port.gt.numpy(), np.asarray(ref.gt))
    for name in ("gd", "dpg"):
        got, want = getattr(port, name).neighbors.numpy(), np.asarray(getattr(ref, name).neighbors)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert port.hnsw.layers_neighbors[0].shape == tuple(ref.hnsw.layers_neighbors[0].shape)
    assert set(port.build_s) == {"ground_truth", "gd", "dpg", "hnsw"}   # kgraph injected
    assert port.peak_bytes == {} and port.exh_time > 0                  # no GPU here
    b = port.index_bytes()
    assert b["kgraph"] == b["gd"] == b["dpg"] == 4000 * 20 * 4 and b["hnsw"] > b["gd"]


@pytest.mark.parametrize("name", ["kgraph", "gd", "dpg"])
def test_recall_curves_match_the_reference_given_its_entries(worlds, name):
    ref, port = worlds
    want = ref.recall_curve(getattr(ref, name))
    searcher = ref.searcher_for(getattr(ref, name))
    entries = {}
    for ef in EFS:
        spec = jengine.SearchSpec(ef=ef, k=1, metric=ref.metric, n_entries=min(8, ef))
        ent, extra = searcher.seed(ref.queries, spec, key=ref.key)
        entries[ef] = (convert.tensor(ent, torch.int32, "cpu"),
                       convert.tensor(extra, torch.int32, "cpu"))
    got = port.recall_curve(getattr(port, name), entries=entries)
    assert [r["ef"] for r in got] == list(EFS)
    for g, w in zip(got, want):
        # the same hits and comps: only the float32 means round apart
        assert round(g["recall"] * 100) == round(w["recall"] * 100), (g, w)
        assert g["comps"] == pytest.approx(w["comps"], rel=1e-6), (g, w)
        assert g["speedup_comps"] == pytest.approx(w["speedup_comps"], rel=1e-6)
        assert g["wall"] > 0 and g["speedup_time"] > 0


def _keys(lines):
    """(record name, its keys) of each ``name,key=value,...`` line; list
    values are cut out first."""
    out = []
    for line in lines:
        parts = re.sub(r"\[[^\]]*\]", "", line).split(",")
        out.append((parts[0], [p.split("=")[0] for p in parts[1:]]))
    return out


def test_printed_lines_carry_the_references_keys(worlds, monkeypatch):
    ref, port = worlds
    got, want = [], []
    for mod, jmod in ((fig3_categories, jfig3), (fig4_hierarchy, jfig4),
                      (fig5_diversification, jfig5), (fig6_comparisons, jfig6)):
        mod.run(port, "SIFT1M", out=got.append)
        jmod.run(ref, "SIFT1M", out=want.append)
    monkeypatch.setattr(jtab1, "PAPER_DATASETS", {"SIFT1M": jsyn.PAPER_DATASETS["SIFT1M"]})
    tab1_datasets.run(scale=0.002, out=got.append, names=["SIFT1M"], device="cpu")
    jtab1.run(scale=0.002, out=want.append)
    assert _keys(got) == _keys(want)
    assert len(got) == 14 + 5 + 5 + 3 + 1
    assert (f"fig5/SIFT1M/index_bytes,kgraph={4000 * 80},gd={4000 * 80},dpg={4000 * 80},"
            f"hnsw={port.index_bytes()['hnsw']}") in got


def test_speedup_at_recall_is_the_references():
    rows = [dict(recall=r, speedup_comps=s) for r, s in
            ((0.7, 90.0), (0.85, 40.0), (0.95, 10.0), (0.9, 30.0))]
    for target in (0.8, 0.9, 0.99):
        assert bench_util.speedup_at_recall(rows, target) == jbench.speedup_at_recall(rows, target)


def test_end_to_end_index_and_search():
    """tests/test_system.py's floor on the port: SIFT1M stand-in at scale
    0.004 (n=4000, 50 queries), NN-Descent k=16, 10 rounds, GD, 8 random
    entries, ef=48: recall@1 >= 0.9 at fewer than n/4 comps a query."""
    base, queries, metric = make_ann_dataset("SIFT1M", scale=0.004, n_queries=50, device="cpu")
    gt = bruteforce.ground_truth(queries, base, 1, metric)
    g = nndescent.build_knn_graph(base, nndescent.NNDescentConfig(k=16, rounds=10),
                                  metric=metric)
    gd = diversify.build_gd_graph(base, g, metric=metric)
    ent = beam_search.random_entries(torch.Generator().manual_seed(0), base.shape[0], 50, 8)
    res = beam_search.beam_search(queries, base, gd.neighbors, ent, ef=48, k=1, metric=metric)
    recall = float((res.ids[:, 0] == gt[:, 0]).float().mean())
    comps = float(res.n_comps.float().mean())
    assert recall >= 0.9, recall
    assert comps < base.shape[0] / 4, comps


def test_end_to_end_hnsw_pipeline():
    """tests/test_system.py's HNSW floor on the port: RAND10M8D at scale
    4e-4 (n=4000, 40 queries), M=12, knn_k=16: recall@1 >= 0.9 at ef=32."""
    base, queries, metric = make_ann_dataset("RAND10M8D", scale=4e-4, n_queries=40,
                                             device="cpu")
    gt = bruteforce.ground_truth(queries, base, 1, metric)
    idx = hnsw.build_hnsw(base, hnsw.HnswConfig(M=12, knn_k=16, brute_threshold=8192))
    res = hnsw.hnsw_search(queries, base, idx, ef=32)
    assert float((res.ids[:, 0] == gt[:, 0]).float().mean()) >= 0.9
