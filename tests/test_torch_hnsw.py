"""HNSW on the port: the layered build, the hierarchy seeder, hierarchical
and flat search, held against live calls into ``repro`` on the CPU.

Given the reference's levels and bottom graph, with every upper layer
exact (under ``brute_threshold``), the build is deterministic: per-layer
adjacency, node lists, slot maps, entry point and stats must be
identical. Given the reference's index (carried across by
``core/convert.py``), the descent's landing ids and comps, and the
searches' ids, n_comps and n_steps must be identical, dists within 1e-5
relative. The levels' draw (a ``torch.Generator``) is held statistically.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beam_search as jbeam
from repro.core import bruteforce as jbrute
from repro.core import engine as jengine
from repro.core import hnsw as jhnsw
from repro_torch.core import convert, engine, hnsw
from repro_torch.core.graph_index import memory_bytes
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, D, Q = 3000, 16, 40
CFG = dict(M=8, knn_k=12)
DIST_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a, dtype=torch.float32):
    return convert.tensor(a, dtype, device="cpu")


def _port_index(idx):
    return convert.hnsw_from_numpy(*[[np.asarray(a) for a in f] if isinstance(f, tuple)
                                     else np.asarray(f) for f in idx], device="cpu")


@pytest.fixture(scope="module", params=["l2", "cos"])
def world(request):
    """The reference's HNSW over n=3000, d=16 (M=8: layers of ~3000, 375,
    47, 6, 1 nodes, the upper ones exact), its levels and bottom graph, and
    40 queries."""
    metric = request.param
    rng = np.random.default_rng(0)
    base = rng.standard_normal((N, D), dtype=np.float32)
    queries = rng.standard_normal((Q, D), dtype=np.float32)
    cfg = jhnsw.HnswConfig(**CFG)
    key = jax.random.PRNGKey(1)
    levels = np.asarray(jhnsw.assign_levels(jax.random.split(key)[0], N, cfg))
    bottom = jbrute.exact_knn_graph(jnp.asarray(base), CFG["knn_k"], metric=metric)
    idx, stats = jhnsw.build_hnsw_with_stats(jnp.asarray(base), cfg, metric=metric,
                                             key=key, bottom_graph=bottom)
    assert max(s["nodes"] for s in stats[1:]) <= cfg.brute_threshold
    return dict(metric=metric, base=base, queries=queries, levels=levels,
                bottom=bottom, idx=idx, stats=stats)


def test_build_hnsw_matches_reference(world):
    """Given the reference's levels and bottom graph: identical layers,
    entry point and per-layer stats."""
    bottom = convert.graph_from_numpy(world["bottom"].neighbors, world["bottom"].dists, "cpu")
    got, stats = hnsw.build_hnsw_with_stats(
        _t(world["base"]), hnsw.HnswConfig(**CFG), metric=world["metric"],
        bottom_graph=bottom, levels=_t(world["levels"], torch.int32))
    want = world["idx"]
    assert got.num_layers == want.num_layers >= 4
    for field in ("layers_neighbors", "layers_nodes", "layers_slot"):
        for g, w in zip(getattr(got, field), getattr(want, field)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)
    assert int(got.entry_point) == int(want.entry_point)
    np.testing.assert_array_equal(got.levels.numpy(), world["levels"])
    assert stats == world["stats"]
    assert [s["source"] for s in stats][:2] == ["bottom_graph", "brute"]
    assert memory_bytes(got) == sum(np.asarray(leaf).nbytes
                                    for leaf in jax.tree_util.tree_leaves(want))
    bg = got.bottom_graph()
    assert torch.equal(bg.neighbors, got.layers_neighbors[0]) and torch.isinf(bg.dists).all()


def test_hierarchy_entries_match_reference(world):
    """The greedy descent on the reference's index: identical landing ids
    and comps (argmin takes the first minimum, as jnp.argmin)."""
    idx = _port_index(world["idx"])
    before = dict(engine.DESCENT_STEPS)
    got_i, got_c = engine.hierarchy_entries(_t(world["queries"]), _t(world["base"]), idx,
                                            world["metric"])
    want_i, want_c = jengine.hierarchy_entries(jnp.asarray(world["queries"]),
                                               jnp.asarray(world["base"]), world["idx"],
                                               world["metric"])
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_i.shape == (Q, 1) and got_i.dtype == torch.int32
    assert engine.DESCENT_STEPS["descents"] == before["descents"] + 1
    # at least one step a layer below the top
    assert engine.DESCENT_STEPS["steps"] >= before["steps"] + idx.num_layers - 1


def _assert_same(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.n_comps.numpy(), np.asarray(want.n_comps))
    assert int(got.n_steps) == int(want.n_steps)
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), **DIST_TOL)


def test_hnsw_search_matches_reference(world):
    idx = _port_index(world["idx"])
    got = hnsw.hnsw_search(_t(world["queries"]), _t(world["base"]), idx, ef=32, k=10,
                           metric=world["metric"])
    want = jhnsw.hnsw_search(jnp.asarray(world["queries"]), jnp.asarray(world["base"]),
                             world["idx"], ef=32, k=10, metric=world["metric"])
    _assert_same(got, want)


def test_flat_search_matches_reference(world):
    """flat-HNSW on the bottom layer from the reference's random draw."""
    idx = _port_index(world["idx"])
    entries = jbeam.random_entries(jax.random.PRNGKey(0), N, Q, 32)
    got = hnsw.flat_search(_t(world["queries"]), _t(world["base"]), idx, ef=32, k=10,
                           metric=world["metric"], entries=_t(entries, torch.int32))
    want = jhnsw.flat_search(jnp.asarray(world["queries"]), jnp.asarray(world["base"]),
                             world["idx"], ef=32, k=10, metric=world["metric"])
    _assert_same(got, want)


def test_hierarchy_seeder_through_the_searcher(world):
    """Searcher.from_hnsw's ``hierarchy`` entry charges the descent's comps
    and walks the bottom layer: the reference's search, bit for bit."""
    idx = _port_index(world["idx"])
    s = engine.Searcher.from_hnsw(_t(world["base"]), idx, metric=world["metric"])
    spec = s.spec(ef=48, k=10, entry="hierarchy")
    ent, comps = s.seed(_t(world["queries"]), spec)
    want_s = jengine.Searcher.from_hnsw(jnp.asarray(world["base"]), world["idx"],
                                        metric=world["metric"])
    want_e, want_c = want_s.seed(jnp.asarray(world["queries"]), want_s.spec(
        ef=48, k=10, entry="hierarchy"))
    np.testing.assert_array_equal(ent.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(comps.numpy(), np.asarray(want_c))
    _assert_same(s.search(_t(world["queries"]), spec),
                 want_s.search(jnp.asarray(world["queries"]),
                               want_s.spec(ef=48, k=10, entry="hierarchy")))


@pytest.mark.parametrize("n,M", [(200_000, 10), (50_000, 16), (3000, 8)])
def test_assign_levels_follows_the_exponential(n, M):
    """Layer l holds about n exp(-l ln M) nodes: within 4 sigma of the
    binomial at every layer below the cap; levels are capped at
    max_layers - 1 and the draw is reproducible from its seed."""
    cfg = hnsw.HnswConfig(M=M)
    lv = hnsw.assign_levels(torch.Generator().manual_seed(3), n, cfg)
    assert lv.dtype == torch.int32 and lv.shape == (n,)
    assert int(lv.min()) >= 0 and int(lv.max()) <= cfg.max_layers - 1
    for layer in range(1, cfg.max_layers):
        p = float(np.exp(-layer * np.log(M)))
        size = int((lv >= layer).sum())
        sigma = float(np.sqrt(n * p * (1 - p)))
        assert abs(size - n * p) <= 4 * sigma + 1e-9, (layer, size, n * p, sigma)
    again = hnsw.assign_levels(torch.Generator().manual_seed(3), n, cfg)
    assert torch.equal(lv, again)


def test_build_hnsw_draws_levels_and_nndescent_layers():
    """Without injected levels the build draws them from its seed, builds a
    layer above brute_threshold with NN-Descent, and keeps its invariants:
    every node on layer l > 0 also on l - 1, ids global, the slot map the
    inverse of the node list, the entry point on the top layer."""
    base = _t(np.random.default_rng(4).standard_normal((1500, 8), dtype=np.float32))
    cfg = hnsw.HnswConfig(M=4, knn_k=8, brute_threshold=200,
                          nndescent=hnsw.NNDescentConfig(k=8, sample=8, sample_nn=8,
                                                         rounds=3))
    idx, stats = hnsw.build_hnsw_with_stats(base, cfg, seed=5)
    again, _ = hnsw.build_hnsw_with_stats(base, cfg, seed=5)
    assert all(torch.equal(a, b) for a, b in zip(idx.layers_neighbors, again.layers_neighbors))
    assert stats[1]["source"] == "nndescent" and stats[1]["nodes"] > 200
    assert stats[-1]["source"] in ("brute", "trivial")
    for layer in range(idx.num_layers):
        nodes, slot, nbrs = (idx.layers_nodes[layer], idx.layers_slot[layer],
                             idx.layers_neighbors[layer])
        assert torch.equal(slot[nodes.long()], torch.arange(nodes.shape[0], dtype=torch.int32))
        assert int((slot >= 0).sum()) == nodes.shape[0]
        valid = nbrs[nbrs >= 0]
        assert bool((slot[valid.long()] >= 0).all())   # neighbors live on the layer
        assert nbrs.shape[1] == (2 * cfg.M if layer == 0 else cfg.M)
        if layer:
            assert bool((idx.layers_slot[layer - 1][nodes.long()] >= 0).all())
    assert int(idx.entry_point) == int(idx.layers_nodes[-1][0])
