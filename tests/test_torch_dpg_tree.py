"""DPG and the RP-tree forest on the port, held against live calls into
``repro`` on the CPU.

Given the reference's ``KnnGraph``, DPG is deterministic: kept ids must be
identical except rows whose greedy argmin meets a float32 near-tie (the
cosine sums run in another order), counted and at most 1%. Given the
reference's planes and threshold points, the forest's leaves, and given its
index, the search's ids and comps, must be identical except queries whose
descent meets a near-tie (|q . plane - offset| within float32 rounding),
counted and at most 1%; distances within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import tree as jtree
from repro.core import build as jbuild
from repro.core import bruteforce as jbrute
from repro.core import diversify as jdiv
from repro.core import nndescent as jnd
from repro_torch.baselines import tree
from repro_torch.core import build, convert, diversify
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, D, Q = 3000, 12, 200
NEAR_TIE_ROWS_MAX = 0.01
# |q . plane - offset| below this is within float32 rounding of the sign test
# at these norms (|q|, |plane| ~ 1, d = 12)
SIGN_TIE = 1e-5


def _t(a, dtype=torch.float32):
    return convert.tensor(a, dtype, device="cpu")


@pytest.fixture(scope="module")
def world():
    """Uniform base (n=3000, d=12), 200 queries, the reference's NN-Descent
    graph (k=20, with two rows padded out: one all-INVALID, one half) and
    its exact k-NN graph (k=10)."""
    key = jax.random.PRNGKey(5)
    base = jax.random.uniform(key, (N, D))
    queries = np.asarray(jax.random.uniform(jax.random.PRNGKey(6), (Q, D)))
    graph = jnd.build_knn_graph(base, jnd.NNDescentConfig(k=20, rounds=6), key=key)
    nbrs, dists = np.array(graph.neighbors), np.array(graph.dists)
    nbrs[7], dists[7] = -1, np.inf
    nbrs[11, 10:], dists[11, 10:] = -1, np.inf
    graph = jnd.KnnGraph(neighbors=jnp.asarray(nbrs), dists=jnp.asarray(dists))
    exact = jbrute.exact_knn_graph(base, 10)
    return dict(base=np.asarray(base), queries=queries, graph=graph, exact=exact)


def _port_graph(g):
    return convert.graph_from_numpy(np.asarray(g.neighbors), np.asarray(g.dists), "cpu")


@pytest.mark.parametrize("graph_name,max_keep", [("graph", None), ("graph", 6),
                                                  ("exact", None), ("exact", 3)])
def test_dpg_prune_matches_reference(world, graph_name, max_keep):
    g = world[graph_name]
    want = np.asarray(jdiv.dpg_prune(jnp.asarray(world["base"]), g, max_keep=max_keep))
    got = diversify.dpg_prune(_t(world["base"]), _port_graph(g), max_keep=max_keep).numpy()
    assert got.shape == want.shape
    diff = np.nonzero((got != want).any(axis=1))[0]
    print(f"dpg_prune {graph_name} max_keep={max_keep}: {len(diff)} near-tie rows of {N}")
    assert len(diff) <= NEAR_TIE_ROWS_MAX * N, diff
    keep = max_keep or g.neighbors.shape[1] // 2
    assert ((got >= 0).sum(axis=1) <= keep).all()
    if graph_name == "graph":
        assert (got[7] == -1).all() and (got[11, :keep] >= 0).all()


def test_dpg_prune_block_size_does_not_change_the_result(world):
    base, g = _t(world["base"]), _port_graph(world["graph"])
    a = diversify.dpg_prune(base, g, chunk=7)
    b = diversify.dpg_prune(base, g, chunk=512)
    c = diversify.dpg_prune(base, g)
    assert torch.equal(a, b) and torch.equal(b, c)


def test_all_invalid_rows_keep_nothing():
    base = _t(np.random.default_rng(0).standard_normal((40, 5)))
    nbrs = torch.full((40, 6), -1, dtype=torch.int32)
    nbrs[1, :3] = torch.tensor([4, 9, 2], dtype=torch.int32)
    dists = torch.where(nbrs >= 0, torch.ones(40, 6), torch.full((40, 6), float("inf")))
    g = diversify.KnnGraph(neighbors=nbrs, dists=dists)
    kept = diversify.dpg_prune(base, g)
    want = np.asarray(jdiv.dpg_prune(jnp.asarray(base.numpy()),
                                     jnd.KnnGraph(neighbors=jnp.asarray(nbrs.numpy()),
                                                  dists=jnp.asarray(dists.numpy()))))
    np.testing.assert_array_equal(kept.numpy(), want)
    assert (kept[0] == -1).all() and (kept[2:] == -1).all() and (kept[1] >= 0).sum() == 3


@pytest.mark.parametrize("max_keep,max_degree", [(None, None), (6, None), (None, 14)])
def test_build_dpg_graph_matches_reference(world, max_keep, max_degree):
    g = world["graph"]
    want = jdiv.build_dpg_graph(jnp.asarray(world["base"]), g, max_keep=max_keep,
                                max_degree=max_degree)
    got = diversify.build_dpg_graph(_t(world["base"]), _port_graph(g), max_keep=max_keep,
                                    max_degree=max_degree)
    assert got.neighbors.shape == tuple(want.neighbors.shape)
    same = (got.neighbors.numpy() == np.asarray(want.neighbors)).all(axis=1)
    print(f"build_dpg_graph max_keep={max_keep} max_degree={max_degree}: "
          f"{int((~same).sum())} rows differ")
    assert same.mean() >= 1 - NEAR_TIE_ROWS_MAX
    assert torch.isnan(got.dists).all()


@pytest.mark.parametrize("spec", [dict(), dict(max_keep=4), dict(max_keep=4, max_degree=6),
                                  dict(reverse="none")])
def test_dpg_stage_matches_the_reference_build(world, spec):
    """BuildSpec(diversify='dpg') over the exact construct: the same graph
    and the same report stats as the reference's builder."""
    common = dict(construct="exact", diversify="dpg", graph_k=10, lid_sample=0, **spec)
    base = world["base"][:1500]
    want = jbuild.GraphBuilder(jbuild.BuildSpec(**common)).build(jnp.asarray(base))
    got = build.GraphBuilder(build.BuildSpec(**common)).build(_t(base))
    np.testing.assert_array_equal(got.graph.neighbors.numpy(), np.asarray(want.graph.neighbors))
    g, w = got.report.summary(), want.report.summary()
    for field in ("spec", "degree", "in_degree", "dropped_reverse_edges", "memory_bytes",
                  "graph_recall_proxy", "hub_ids", "rounds"):
        assert g[field] == w[field], field


def _ref_draws(key, n, n_trees, depth):
    """The planes and threshold points the reference's build_forest drew."""
    n_internal = 2**depth - 1
    planes, samples = [], []
    for kt in jax.random.split(key, n_trees):
        kp, ko = jax.random.split(kt)
        p = jax.random.normal(kp, (n_internal, D))
        planes.append(np.asarray(p / jnp.linalg.norm(p, axis=1, keepdims=True)))
        samples.append(np.asarray(jax.random.randint(ko, (n_internal,), 0, n)))
    return planes, samples


def _sign_margins(x, planes, offsets, depth):
    """float64 min |x . plane - offset| along each row's path, per tree:
    (T, rows)."""
    out = []
    for p, o in zip(planes.astype(np.float64), offsets.astype(np.float64)):
        node = np.zeros(x.shape[0], np.int64)
        m_min = np.full((x.shape[0],), np.inf)
        for _ in range(depth):
            m = (p[node] * x).sum(-1) - o[node]
            m_min = np.minimum(m_min, np.abs(m))
            node = 2 * node + 1 + (m > 0)
        out.append(m_min)
    return np.stack(out)


def _leaf_of(leaves, n):
    """(T, n) leaf of each point, -1 where a full leaf dropped it."""
    T, n_leaves, cap = leaves.shape
    out = np.full((T, n), -1)
    for t in range(T):
        ids = leaves[t].reshape(-1)
        out[t, ids[ids >= 0]] = np.repeat(np.arange(n_leaves), cap)[ids >= 0]
    return out


@pytest.mark.parametrize("n_trees,depth,leaf_cap", [(4, None, None), (3, 4, 40)])
def test_build_forest_from_the_references_draws(world, n_trees, depth, leaf_cap):
    """Every (tree, point) routed to the reference's leaf, except where the
    point lies on a plane within rounding: the threshold points themselves
    (exact ties, which either sum order may break either way), counted."""
    key = jax.random.PRNGKey(3)
    base = world["base"]
    want = jtree.build_forest(jnp.asarray(base), n_trees=n_trees, depth=depth,
                              leaf_cap=leaf_cap, key=key)
    assert want.depth == (tree.default_depth(N) if depth is None else depth)
    planes, samples = _ref_draws(key, N, n_trees, want.depth)
    np.testing.assert_array_equal(np.stack(planes), np.asarray(want.planes))
    got = tree.build_forest(_t(base), n_trees=n_trees, depth=depth, leaf_cap=leaf_cap,
                            planes=[_t(p) for p in planes],
                            sample_ids=[torch.from_numpy(s.copy()) for s in samples])
    assert got.depth == want.depth
    assert got.leaves.shape == tuple(want.leaves.shape)
    np.testing.assert_allclose(got.offsets.numpy(), np.asarray(want.offsets),
                               rtol=1e-5, atol=1e-6)
    g_leaf, w_leaf = _leaf_of(got.leaves.numpy(), N), _leaf_of(np.asarray(want.leaves), N)
    margins = _sign_margins(base.astype(np.float64), np.asarray(want.planes),
                            np.asarray(want.offsets), want.depth)
    both = (g_leaf >= 0) & (w_leaf >= 0)
    moved = both & (g_leaf != w_leaf)
    assert (margins[moved] < SIGN_TIE).all()
    assert moved.sum() <= NEAR_TIE_ROWS_MAX * moved.size
    # A tie point that lands in a full leaf drops that leaf's last point
    # (or spares one where it left): such drops only in leaves that a tie
    # point reached in one build and not the other. And the reference
    # routes every point past leaf_cap to leaves[t, 0, 0] with id -1, so a
    # tree with a full leaf loses the point in that slot there.
    wl = np.asarray(want.leaves)
    ties = (margins < SIGN_TIE) & (g_leaf != w_leaf)
    touched = {(t, int(leaf)) for t, i in zip(*np.nonzero(ties))
               for leaf in (g_leaf[t, i], w_leaf[t, i]) if leaf >= 0}
    dropped = (g_leaf >= 0) != (w_leaf >= 0)
    for t, i in zip(*np.nonzero(dropped & ~ties)):
        clobbered = w_leaf[t, i] < 0 and g_leaf[t, i] == 0 and wl[t, 0, 0] < 0 \
            and got.leaves[t, 0, 0] == i
        assert clobbered or (t, int(max(g_leaf[t, i], w_leaf[t, i]))) in touched, (t, i)
    print(f"build_forest: {int(ties.sum())} near-tie (tree, point) pairs of {moved.size}, "
          f"{int((dropped & ~ties).sum())} points dropped from a full leaf in one build only")
    if leaf_cap is None:
        assert got.leaves.shape[2] == tree.default_leaf_cap(N, got.depth)


@pytest.mark.parametrize("k", [1, 5])
def test_forest_search_on_the_references_index(world, k):
    base, queries = world["base"], world["queries"]
    want_idx = jtree.build_forest(jnp.asarray(base), n_trees=6, key=jax.random.PRNGKey(4))
    wd, wi, wc = (np.asarray(a) for a in jtree.forest_search(
        jnp.asarray(queries), jnp.asarray(base), want_idx, k=k))
    idx = convert.forest_from_reference(want_idx.planes, want_idx.offsets, want_idx.leaves,
                                        want_idx.depth, device="cpu")
    gd, gi, gc = tree.forest_search(_t(queries), _t(base), idx, k=k)
    gd, gi, gc = gd.numpy(), gi.numpy(), gc.numpy()
    diff = (gi != wi).any(axis=1) | (gc != wc)
    margins = _sign_margins(queries.astype(np.float64), np.asarray(want_idx.planes),
                            np.asarray(want_idx.offsets), want_idx.depth).min(axis=0)
    print(f"forest_search k={k}: {int(diff.sum())} near-tie rows of {Q}")
    assert (margins[diff] < SIGN_TIE).all()
    assert diff.sum() <= max(1, NEAR_TIE_ROWS_MAX * Q)
    np.testing.assert_allclose(gd[~diff], wd[~diff], rtol=1e-5, atol=1e-5)
    assert (gc >= want_idx.planes.shape[0] * want_idx.depth).all()
    assert gi.dtype == np.int32 and gc.dtype == np.int32


def test_forest_search_finds_most_nearest_neighbors(world):
    """The port's own draws: the forest finds the true nearest neighbor of
    most queries, at far fewer comps than n (a statistical hold: the
    reference's own forest, with its draws, on the same data)."""
    base, queries = _t(world["base"]), _t(world["queries"])
    gt = np.asarray(jbrute.ground_truth(jnp.asarray(world["queries"]),
                                        jnp.asarray(world["base"]), 1))[:, 0]
    idx = tree.build_forest(base, n_trees=8, seed=1)
    _, ids, comps = tree.forest_search(queries, base, idx, k=1)
    want_idx = jtree.build_forest(jnp.asarray(world["base"]), n_trees=8,
                                  key=jax.random.PRNGKey(1))
    _, wids, wcomps = jtree.forest_search(jnp.asarray(world["queries"]),
                                          jnp.asarray(world["base"]), want_idx, k=1)
    got_r = float((ids[:, 0].numpy() == gt).mean())
    want_r = float((np.asarray(wids)[:, 0] == gt).mean())
    assert got_r >= want_r - 0.05, (got_r, want_r)
    assert float(comps.float().mean()) < N / 2
    assert abs(float(comps.float().mean()) - float(np.asarray(wcomps).mean())) < 0.1 * N
