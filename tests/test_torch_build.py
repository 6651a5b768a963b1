"""The build: NN-Descent, GD + reverse union, and the pipeline, held against
live calls into ``repro`` on the CPU.

GD and the reverse union are deterministic given a ``KnnGraph``: their
adjacency and stats must be identical, except GD rows whose keep decision
sits on a float32 near-tie (|pair_d - cand_d| < 1e-5 * cand_d), where the
two libraries' summation orders may fall either way. NN-Descent draws from
a ``torch.Generator`` and is held statistically on the reference's own
small fixture.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build as jbuild
from repro.core import bruteforce as jbrute
from repro.core import diversify as jdiv
from repro.core import engine as jengine
from repro.core import nndescent as jnd
from repro_torch.core import build, convert, diversify, nndescent
from repro_torch.core.engine import SearchSpec
from repro_torch.kernels import ref
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# tests/test_graph_build.py's fixture: uniform 3000 x 12, k = 10
SMALL_CFG = dict(k=10, sample=10, sample_nn=10, reverse=20, rounds=12)


def _t(a, dtype=torch.float32):
    return convert.tensor(a, dtype, device="cpu")


@pytest.fixture(scope="module")
def small_world():
    key = jax.random.PRNGKey(0)
    base = jax.random.uniform(key, (3000, 12))
    exact = jbrute.exact_knn_graph(base, 10)
    graph, _ = jnd.build_knn_graph_with_stats(base, jnd.NNDescentConfig(**SMALL_CFG),
                                              key=key)
    return (np.asarray(base), exact, graph,
            float(jnd.graph_recall(graph, exact)))


def test_nndescent_recall_on_reference_fixture(small_world):
    base, exact, _, ref_recall = small_world
    graph, stats = nndescent.build_knn_graph_with_stats(
        _t(base), nndescent.NNDescentConfig(**SMALL_CFG), seed=0)
    got = nndescent.graph_recall(graph, convert.graph_from_numpy(
        exact.neighbors, exact.dists, "cpu"))
    assert got >= 0.90, got
    assert abs(got - ref_recall) <= 0.03, (got, ref_recall)
    assert stats.rounds == len(stats.update_curve) <= SMALL_CFG["rounds"]
    assert stats.threshold == 0.002 * 3000 * 10
    if stats.converged:
        assert stats.update_curve[-1] <= stats.threshold
    # every stored distance is the true distance of its id (an (id, dist)
    # pair can never be assembled from two push-back writers); same formula,
    # so only the last-ulp rounding of the sum may differ
    nb = graph.neighbors
    true_d = ref.gather_distance_ref(_t(base), nb, _t(base))
    torch.testing.assert_close(graph.dists, true_d, rtol=1e-6, atol=0)
    # rows are deduped, self-free and sorted ascending
    assert (graph.dists[:, 1:] >= graph.dists[:, :-1]).all()
    own = torch.arange(3000, dtype=torch.int32)[:, None]
    assert not (nb == own).any()
    srt, _ = torch.sort(nb, dim=1)
    assert not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()


def test_nndescent_is_deterministic_given_the_seed(small_world):
    base = _t(small_world[0][:500])
    cfg = nndescent.NNDescentConfig(**{**SMALL_CFG, "rounds": 3})
    a = nndescent.build_knn_graph(base, cfg, seed=5)
    b = nndescent.build_knn_graph(base, cfg, seed=5)
    assert torch.equal(a.neighbors, b.neighbors)
    assert torch.equal(a.dists, b.dists)



@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_round_pool_scores_match_reference(small_world, metric):
    """One round's candidate pool (steps 1-3) scored by the port's
    _score_chunked (one ops.gather_distance_pool call) against the
    reference's live _score_chunked on the same pool, within 1e-5; the pool
    has the reference's width and no self ids."""
    base = small_world[0]
    cfg = nndescent.NNDescentConfig(**SMALL_CFG)
    gen = torch.Generator().manual_seed(3)
    bt = _t(base)
    ids = nndescent._random_init(gen, base.shape[0], cfg.k)
    isnew = torch.ones_like(ids, dtype=torch.bool)
    pool = nndescent._round_pool(ids, isnew, gen, cfg)
    n = base.shape[0]
    assert pool.shape == (n, cfg.sample * cfg.sample_nn + cfg.reverse
                          + max(2, cfg.reverse // 4) * cfg.sample_nn)
    assert not (pool == torch.arange(n, dtype=torch.int32)[:, None]).any()
    assert bool((pool < 0).any()) and bool((pool >= 0).any())
    got = nndescent._score_chunked(bt, pool, metric, cfg.chunk)
    assert torch.equal(got, ref.gather_distance_pool_ref(bt, pool, metric, cfg.chunk))
    want = jnd._score_chunked(jnp.asarray(base), jnp.asarray(pool.numpy()), metric,
                              cfg.chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

def _near_tie_rows(base, ids, dists, rows, rtol=1e-5):
    """Rows whose candidate set holds a pair with |d(s, c) - d(v, c)| <
    rtol * d(v, c): the occlusion test there may go either way in float32."""
    out = []
    for r in rows:
        c = ids[r][ids[r] >= 0]
        cd = dists[r][ids[r] >= 0]
        x = base[c].astype(np.float64)
        pair = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        close = np.abs(pair - cd[None, :]) < rtol * np.maximum(cd[None, :], 1e-30)
        np.fill_diagonal(close, False)
        out.append(bool(close.any()))
    return np.array(out)


def test_gd_prune_matches_reference(small_world):
    base, _, graph, _ = small_world
    want = np.asarray(jdiv.gd_prune(jnp.asarray(base), graph))
    got = diversify.gd_prune(_t(base), convert.graph_from_numpy(
        graph.neighbors, graph.dists, "cpu")).numpy()
    diff = np.nonzero((got != want).any(axis=1))[0]
    srt_d, srt_i = jax.vmap(lambda d, i: (d[jnp.argsort(d, stable=True)],
                                          i[jnp.argsort(d, stable=True)]))(
        graph.dists, graph.neighbors)
    assert _near_tie_rows(base, np.asarray(srt_i), np.asarray(srt_d), diff).all(), diff
    assert len(diff) <= 0.01 * len(got)


def test_reverse_union_matches_reference(small_world):
    """Given the same kept adjacency, the union and its stats are identical."""
    base, _, graph, _ = small_world
    kept = np.asarray(jdiv.gd_prune(jnp.asarray(base), graph))
    for cap in (10, 6):
        want, wstats = jdiv.add_reverse_edges_with_stats(jnp.asarray(kept), cap)
        got, gstats = diversify.add_reverse_edges_with_stats(_t(kept, torch.int32), cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert tuple(gstats) == tuple(wstats)
        assert gstats.dropped == wstats.dropped


def test_build_gd_graph_matches_reference(small_world):
    base, _, graph, _ = small_world
    want = jdiv.build_gd_graph(jnp.asarray(base), graph)
    got = diversify.build_gd_graph(_t(base), convert.graph_from_numpy(
        graph.neighbors, graph.dists, "cpu"))
    same = (got.neighbors.numpy() == np.asarray(want.neighbors)).all(axis=1)
    assert same.mean() >= 0.99
    assert torch.isnan(got.dists).all()


def test_graph_recall_proxy_matches_reference(small_world):
    base, _, graph, _ = small_world
    for metric in ("l2", "cos"):
        want = jbuild.graph_recall_proxy(jnp.asarray(base), graph, metric=metric)
        got = build.graph_recall_proxy(_t(base), convert.graph_from_numpy(
            graph.neighbors, graph.dists, "cpu"), metric=metric)
        assert got == pytest.approx(want, abs=1e-3)


def test_specs_mirror_the_reference():
    assert build.BuildSpec()._asdict() == jbuild.BuildSpec()._asdict()
    assert nndescent.NNDescentConfig()._asdict() == jnd.NNDescentConfig()._asdict()
    assert SearchSpec()._asdict() == jengine.SearchSpec()._asdict()
    assert SearchSpec().num_seeds == jengine.SearchSpec().num_seeds


# every stage the reference registers is ported (construct="incremental"
# since the mutation slice); a scorer's name is no compress stage
@pytest.mark.parametrize("stage", [dict(compress="bogus"), dict(diversify="bogus"),
                                   dict(compress="sq8"), dict(construct="bogus")])
def test_unported_or_unknown_stages_raise(stage):
    assert set(build.CONSTRUCTORS) == set(jbuild.CONSTRUCTORS)
    assert set(build.DIVERSIFIERS) == set(jbuild.DIVERSIFIERS)
    assert set(build.COMPRESSORS) == set(jbuild.COMPRESSORS)
    with pytest.raises(ValueError, match="unknown"):
        build.GraphBuilder(build.BuildSpec(**stage))
    with pytest.raises(ValueError, match="reverse"):
        build.GraphBuilder(build.BuildSpec(reverse="both"))


@pytest.mark.parametrize("diversify_stage", ["gd", "none", "dpg"])
def test_graph_builder_report(small_world, diversify_stage):
    base = _t(small_world[0][:1200])
    spec = build.BuildSpec(graph_k=10, nd_rounds=4, diversify=diversify_stage,
                           lid_sample=64, n_hubs=8)
    res = build.GraphBuilder(spec).build(base, seed=1)
    rep = res.report
    assert res.graph.neighbors.shape == (1200, 10)
    assert rep.rounds == len(rep.update_curve) <= 4
    assert 0.0 <= rep.graph_recall_proxy <= 1.0
    assert rep.degree["max"] <= 10 and rep.n == 1200 and rep.d == 12
    assert rep.wall_total_s >= rep.wall_construct_s > 0
    assert rep.memory_bytes == 1200 * 10 * 4
    assert len(rep.hub_ids) == 8 and res.hubs.tolist() == rep.hub_ids
    assert rep.lid > 0 and rep.peak_memory_bytes == {}  # no GPU here
    assert rep.summary()["spec"]["diversify"] == diversify_stage
    exact = build.GraphBuilder(build.BuildSpec(construct="exact", graph_k=10,
                                               diversify=diversify_stage,
                                               lid_sample=0)).build(base)
    # the proxy scores the constructed (pre-diversify) graph
    assert exact.report.graph_recall_proxy == 1.0


def test_compress_stages_attach_pq_tables(small_world):
    """compress='pq' trains from the engine's lazy-path seed, so the table a
    build attaches equals what a fresh Searcher with the same seed trains;
    memory counts the codebooks and codes; 'opq' carries its rotation."""
    from repro_torch.core.engine import Searcher

    base = _t(small_world[0][:1000])
    common = dict(graph_k=10, nd_rounds=2, proxy_sample=0, lid_sample=0,
                  pq_m=4, pq_k=16, pq_iters=3)
    res = build.GraphBuilder(build.BuildSpec(compress="pq", **common)).build(base, seed=3)
    idx = res.pq
    assert idx.codes.shape == (1000, 4) and idx.codebooks.shape == (4, 16, 3)
    assert idx.rotation is None
    assert res.report.memory_bytes == 1000 * 10 * 4 + 4 * 16 * 3 * 4 + 1000 * 4
    s = Searcher.from_build(base, res, rng_seed=3)
    spec = s.spec(scorer="pq", pq_m=4, pq_k=16, pq_iters=3)
    assert s.pq is idx and s.pq_index(spec) is idx
    lazy = Searcher(base, res.graph.neighbors, rng_seed=3).pq_index(spec)
    assert torch.equal(lazy.codebooks, idx.codebooks) and torch.equal(lazy.codes, idx.codes)
    opq = build.GraphBuilder(build.BuildSpec(compress="opq", opq_iters=1, **common)
                             ).build(base, seed=3).pq
    assert opq.rotation.shape == (12, 12)
    torch.testing.assert_close(opq.rotation @ opq.rotation.T, torch.eye(12),
                               rtol=0, atol=1e-5)


def test_compress_validates_pq_m_up_front():
    """d % pq_m is checked before any construct round runs, as in the
    reference."""
    with pytest.raises(ValueError, match="pq_m"):
        build.GraphBuilder(build.BuildSpec(compress="pq", pq_m=5)).build(
            torch.zeros((50, 12)))
