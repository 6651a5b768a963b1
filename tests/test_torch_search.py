"""Beam search, brute force and the list utilities: the port against live
calls into ``repro`` on the same numpy inputs, on the CPU.

Beam search is deterministic given base, graph and entry ids, so ids,
n_comps and n_steps must be identical and dists agree within rtol 1e-5
(float32 sums taken in another order). Brute force must return identical
ids except where two candidates' distances tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import pq as jpq
from repro.core import beam_search as jbeam
from repro.core import bruteforce as jbrute
from repro.core import diversify as jdiv
from repro.core import graph_index as jgi
from repro.core import lid as jlid
from repro.core import scorers as jscorers
from repro.core import topk as jtopk
from repro_torch.core import beam_search, bruteforce, convert, graph_index, lid, topk
from repro_torch.core.engine import SearchSpec
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

METRICS = ["l2", "ip", "cos"]
DIST_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a, dtype=torch.float32):
    return convert.tensor(a, dtype, device="cpu")


@pytest.fixture(scope="module")
def world():
    """n=2000, d=16 base, 48 queries, and the reference's exact 12-NN graph
    unioned with its reverse edges (a navigable graph at test size)."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((2000, 16), dtype=np.float32)
    queries = rng.standard_normal((48, 16), dtype=np.float32)
    g = jbrute.exact_knn_graph(jnp.asarray(base), 12)
    nbrs = np.asarray(jdiv.add_reverse_edges(g.neighbors, 16))
    entries = np.asarray(jbeam.random_entries(jax.random.PRNGKey(3), 2000, 48, 8))
    return base, queries, nbrs, entries


def _ref_search(world, metric, **kw):
    base, queries, nbrs, entries = world
    return jbeam.beam_search(jnp.asarray(queries), jnp.asarray(base),
                             jnp.asarray(nbrs), jnp.asarray(entries),
                             metric=metric, **kw)


def _port_search(world, metric, **kw):
    base, queries, nbrs, entries = world
    return beam_search.beam_search(_t(queries), _t(base), _t(nbrs, torch.int32),
                                   _t(entries, torch.int32), metric=metric, **kw)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.n_comps.numpy(), np.asarray(want.n_comps))
    assert int(got.n_steps) == int(want.n_steps)
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), **DIST_TOL)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("expand_width", [1, 2])
def test_beam_search_matches_reference(world, metric, expand_width):
    kw = dict(ef=32, k=10, expand_width=expand_width)
    got = _port_search(world, metric, **kw)
    want = _ref_search(world, metric, **kw)
    _assert_same(got, want)
    np.testing.assert_array_equal(got.bytes_touched.numpy(),
                                  np.asarray(want.n_comps) * 4 * 16)


def test_beam_search_padded_rows_are_inert(world):
    """q_valid padding rows return (INVALID, +inf, 0 comps) and leave every
    real row exactly as the reference has it."""
    q_valid = np.arange(48) % 3 != 0
    kw = dict(ef=24, k=5)
    got = _port_search(world, "l2", q_valid=torch.from_numpy(q_valid), **kw)
    want = _ref_search(world, "l2", q_valid=jnp.asarray(q_valid), **kw)
    _assert_same(got, want)
    assert (got.ids.numpy()[~q_valid] == -1).all()
    assert (got.n_comps.numpy()[~q_valid] == 0).all()


def test_beam_search_max_steps_cut(world):
    kw = dict(ef=32, k=4, max_steps=5)
    got = _port_search(world, "l2", **kw)
    _assert_same(got, _ref_search(world, "l2", **kw))
    assert int(got.n_steps) == 5


def test_beam_search_tombstones_match_reference(world):
    """A uint32 tombstone bitmap (with bit-31 ids dead) carried across by
    convert drops the same ids in both."""
    base, queries, nbrs, entries = world
    rng = np.random.default_rng(5)
    dead = np.concatenate([rng.choice(2000, 200, replace=False), [31, 63, 1999]])
    alive = np.ones(2000, bool)
    alive[dead] = False
    words = np.zeros((2000 + 31) // 32, np.uint32)
    for i in dead:
        words[i >> 5] |= np.uint32(1 << (i & 31))
    want = jbeam.beam_search(jnp.asarray(queries), jnp.asarray(base),
                             jnp.asarray(nbrs), jnp.asarray(entries), ef=32, k=10,
                             tombstones=jnp.asarray(words))
    got = beam_search.beam_search(_t(queries), _t(base), _t(nbrs, torch.int32),
                                  _t(entries, torch.int32), ef=32, k=10,
                                  tombstones=convert.bitmap_from_uint32(words, "cpu"))
    _assert_same(got, want)
    ids = got.ids.numpy()
    assert not np.isin(ids[ids >= 0], dead).any()


@pytest.fixture(scope="module")
def tables(world):
    """The reference's sq8 table and PQ index (M=8, K=64) on the world."""
    base = jnp.asarray(world[0])
    return {"sq8": jscorers.build_sq8(base),
            "pq": jpq.build_pq(base, M=8, K=64, iters=5, key=jax.random.PRNGKey(2))}


def _states(world, tables, scorer, metric):
    """(reference scorer_state, the same carried across to the port): the
    sq8 table, or the PQ codes with the reference's LUTs injected."""
    if scorer == "sq8":
        t = tables["sq8"]
        ref_state = (t.codes, t.scale, t.mn)
        port = convert.sq8_from_numpy(*(np.asarray(a) for a in ref_state), device="cpu")
        return ref_state, tuple(port)
    idx = tables["pq"]
    luts = jpq.build_adc_luts(jnp.asarray(world[1]), idx.codebooks, metric)
    return ((idx.codes, luts),
            (convert.tensor(np.asarray(idx.codes), torch.uint8, "cpu"),
             _t(np.asarray(luts))))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("rerank", [0, 16])
@pytest.mark.parametrize("scorer", ["sq8", "pq"])
def test_compressed_beam_search_matches_reference(world, tables, scorer, rerank, metric):
    """Given the reference's graph, entries and tables (its LUTs injected
    for pq): identical ids, n_comps, n_steps and bytes_touched; dists
    within rtol 1e-5."""
    ref_state, port_state = _states(world, tables, scorer, metric)
    kw = dict(ef=32, k=10, scorer=scorer, rerank=rerank)
    want = _ref_search(world, metric, scorer_state=ref_state, **kw)
    got = _port_search(world, metric, scorer_state=port_state, **kw)
    _assert_same(got, want)
    np.testing.assert_array_equal(got.bytes_touched.numpy(),
                                  np.asarray(want.bytes_touched))


def test_compressed_scorers_need_their_state(world):
    for scorer in ("sq8", "pq"):
        with pytest.raises(ValueError, match="scorer_state"):
            _port_search(world, "l2", ef=16, scorer=scorer)


def test_rerank_slice_matches_reference():
    for ef, k, r in [(64, 10, 0), (64, 10, 16), (64, 10, 5), (32, 1, 100)]:
        assert beam_search.rerank_slice(ef, k, r) == jbeam.rerank_slice(ef, k, r)


def test_searcher_trains_pq_once_and_serves_compressed_scorers(world):
    """Without an attached table the pq scorer trains one on first use and
    caches it; search_stream answers every row under sq8 and pq, and a tile
    equals a direct search of it."""
    base, queries, nbrs, _ = world
    s = convert.searcher_from_numpy(base, nbrs, device="cpu", rng_seed=3)
    assert s.pq is None
    spec = s.spec(ef=32, k=10, scorer="pq", pq_k=32, pq_iters=3, rerank=16)
    idx = s.pq_index(spec)
    assert s.pq is idx and s.pq_index(spec) is idx and idx.codes.shape == (2000, 8)
    assert s.sq8_index() is s.sq8_index()
    from repro_torch.core.engine import _fold
    for sp in (spec, spec._replace(scorer="sq8")):
        res = s.search_stream(_t(queries), sp, 7, tile_q=20)
        assert res.ids.shape == (48, 10) and (res.ids >= 0).all()
        direct = s.search(_t(queries[40:]), sp, _fold(7, 2))
        assert torch.equal(res.ids[40:], direct.ids)
        assert torch.equal(res.bytes_touched[40:], direct.bytes_touched)


def test_searcher_with_injected_entries_matches_beam_search(world):
    base, queries, nbrs, entries = world
    s = convert.searcher_from_numpy(base, nbrs, device="cpu")
    res = s.search(_t(queries), s.spec(ef=32, k=10),
                   entries=_t(entries, torch.int32))
    _assert_same(res, _ref_search(world, "l2", ef=32, k=10))


def test_searcher_rejects_unported_options(world):
    base, queries, nbrs, _ = world
    s = convert.searcher_from_numpy(base, nbrs, device="cpu")
    q = _t(queries)
    # the tiers are ported: what still raises is the reference's errors
    for placement in ("host", "disk"):
        with pytest.raises(ValueError, match="use a base-free scorer"):
            s.search(q, s.spec(base_placement=placement, scorer="exact"))
    with pytest.raises(ValueError, match="unknown base_placement"):
        s.search(q, s.spec(base_placement="tape", scorer="pq", pq_k=16))
    with pytest.raises(ValueError, match="unknown store_dtype"):
        s.search(q, s.spec(base_placement="host", store_dtype="f16", scorer="sq8"))
    from repro_torch.core.filters import FilterSpec
    with pytest.raises(ValueError, match="needs metadata column 'tenant'"):
        s.search(q, s.spec(filter=FilterSpec(tenant=1)))
    with pytest.raises(ValueError, match="unknown entry strategy"):
        s.search(q, s.spec(entry="bogus"))
    with pytest.raises(ValueError, match="needs a Searcher built from an HnswIndex"):
        s.search(q, s.spec(entry="hierarchy"))
    with pytest.raises(ValueError, match="unknown termination mode"):
        s.search(q, s.spec(term="bogus"))
    with pytest.raises(ValueError, match="metric"):
        s.search(q, SearchSpec(metric="ip"))
    with pytest.raises(ValueError, match="unknown scorer"):
        s.search(q, s.spec(scorer="bogus"))


def test_search_stream_tiles_and_masks(world):
    """Streaming splits a batch into fixed tiles (the last padded and
    masked): every row is answered, and a tile's rows equal a direct search
    of that tile with the same seed."""
    base, queries, nbrs, _ = world
    s = convert.searcher_from_numpy(base, nbrs, device="cpu", rng_seed=4)
    spec = s.spec(ef=32, k=10)
    res = s.search_stream(_t(queries), spec, 7, tile_q=20)
    assert res.ids.shape == (48, 10) and (res.ids >= 0).all()
    from repro_torch.core.engine import _fold
    direct = s.search(_t(queries[40:]), spec, _fold(7, 2))
    assert torch.equal(res.ids[40:], direct.ids)
    assert torch.equal(res.n_comps[40:], direct.n_comps)


def test_random_entries_are_deduped_and_seeded():
    g = torch.Generator().manual_seed(11)
    e = beam_search.random_entries(g, 50, 200, 8)
    assert e.dtype == torch.int32 and e.shape == (200, 8)
    valid = e[e >= 0]
    assert valid.max() < 50 and (e == -1).any()  # collisions at E/n = 0.16
    for row in e.tolist():
        ok = [i for i in row if i >= 0]
        assert len(ok) == len(set(ok))
    again = beam_search.random_entries(torch.Generator().manual_seed(11), 50, 200, 8)
    assert torch.equal(e, again)


def test_visited_bits_match_reference_uint32():
    """_mark_visited / _is_visited on int32 words against the reference's
    uint32 words, with bit-31 ids and ids in the partial last word."""
    n = 100                                     # W = 4, last word partial
    ids = np.array([[31, 63, 99, 96, -1, 5], [0, 95, -1, -1, 64, 97]], np.int32)
    vis = np.zeros((2, 4), np.uint32)
    want = jbeam._mark_visited(jnp.asarray(vis), jnp.asarray(ids))
    got = beam_search._mark_visited(convert.bitmap_from_uint32(vis, "cpu"),
                                    _t(ids, torch.int32))
    np.testing.assert_array_equal(convert.bitmap_to_uint32(got), np.asarray(want))
    probe = np.array([[31, 30, 99, 98, -1, 5], [97, 96, 95, 0, 1, 64]], np.int32)
    np.testing.assert_array_equal(
        beam_search._is_visited(got, _t(probe, torch.int32)).numpy(),
        np.asarray(jbeam._is_visited(want, jnp.asarray(probe))))


def test_step_budget_and_dedup_rows_match_reference():
    for ef, w in [(64, 1), (64, 2), (10, 3), (48, 4)]:
        assert beam_search.default_max_steps(ef, w) == jbeam.default_max_steps(ef, w)
    ids = np.array([[3, 1, 3, -1, 1], [2, 2, 2, 0, -1]], np.int32)
    np.testing.assert_array_equal(beam_search.dedup_rows(_t(ids, torch.int32)).numpy(),
                                  np.asarray(jbeam.dedup_rows(jnp.asarray(ids))))


# -- brute force --------------------------------------------------------------


def _assert_ids_equal_except_ties(got_d, got_i, want_d, want_i, rtol=1e-5):
    """Identical ids, except where the two disagreeing entries' distances
    tie within rtol (they then rank equally)."""
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    diff = got_i != want_i
    if diff.any():
        np.testing.assert_allclose(np.asarray(got_d)[diff], np.asarray(want_d)[diff],
                                   rtol=rtol)
    assert diff.mean() < 0.01, diff.mean()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n,chunk", [(2500, 1000), (700, 16384)])
def test_exact_search_matches_reference(metric, n, chunk):
    rng = np.random.default_rng(n)
    base = rng.standard_normal((n, 16), dtype=np.float32)
    queries = rng.standard_normal((33, 16), dtype=np.float32)
    gd, gi = bruteforce.exact_search(_t(queries), _t(base), 10, metric, chunk=chunk)
    wd, wi = jbrute.exact_search(jnp.asarray(queries), jnp.asarray(base), 10,
                                 metric, chunk=chunk)
    _assert_ids_equal_except_ties(gd.numpy(), gi.numpy(), wd, wi)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-4)
    gt = bruteforce.ground_truth(_t(queries), _t(base), 10, metric)
    assert torch.equal(gt, gi)


def test_exact_search_ties_keep_the_lower_id():
    base = np.zeros((40, 4), np.float32)          # every row ties at distance 0
    got_d, got_i = bruteforce.exact_search(_t(base[:3]), _t(base), 5, chunk=16)
    _, want_i = jbrute.exact_search(jnp.asarray(base[:3]), jnp.asarray(base), 5, chunk=16)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i.numpy(), [[0, 1, 2, 3, 4]] * 3)


def test_exact_knn_graph_matches_reference():
    rng = np.random.default_rng(9)
    base = rng.standard_normal((600, 8), dtype=np.float32)
    got = bruteforce.exact_knn_graph(_t(base), 10, chunk=256)
    want = jbrute.exact_knn_graph(jnp.asarray(base), 10)
    _assert_ids_equal_except_ties(got.dists.numpy(), got.neighbors.numpy(),
                                  want.dists, want.neighbors)


# -- list utilities and graph statistics -------------------------------------


def test_topk_smallest_breaks_ties_like_lax_top_k():
    rng = np.random.default_rng(2)
    d = rng.integers(0, 5, size=(50, 40)).astype(np.float32)
    d[:, 7] = np.inf
    gv, gi = topk.topk_smallest(_t(d), 12)
    wv, wi = jtopk.topk_smallest(jnp.asarray(d), 12)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_dedup_and_merge_match_reference():
    rng = np.random.default_rng(4)
    d = rng.integers(0, 6, size=(30, 24)).astype(np.float32)
    i = rng.integers(-1, 10, size=(30, 24)).astype(np.int32)
    gd, gi = topk.dedup_by_id(_t(d), _t(i, torch.int32))
    wd, wi = jax.vmap(jtopk.dedup_by_id)(jnp.asarray(d), jnp.asarray(i))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    for dedup in (True, False):
        gd, gi = topk.merge_candidates(_t(d[:, :12]), _t(i[:, :12], torch.int32),
                                       _t(d[:, 12:]), _t(i[:, 12:], torch.int32),
                                       9, dedup=dedup)
        wd, wi = jax.vmap(lambda a, b, c, e: jtopk.merge_candidates(
            a, b, c, e, 9, dedup=dedup))(jnp.asarray(d[:, :12]), jnp.asarray(i[:, :12]),
                                         jnp.asarray(d[:, 12:]), jnp.asarray(i[:, 12:]))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    found = rng.integers(0, 20, size=(30, 10)).astype(np.int32)
    true = rng.integers(-1, 20, size=(30, 5)).astype(np.int32)
    assert topk.recall_at_k(_t(found, torch.int32), _t(true, torch.int32)) == \
        pytest.approx(float(jtopk.recall_at_k(jnp.asarray(found), jnp.asarray(true))))


def test_graph_statistics_match_reference(world):
    _, _, nbrs, _ = world
    t = _t(nbrs, torch.int32)
    alive = np.random.default_rng(1).random(2000) > 0.2
    assert graph_index.degree_distribution(t) == jgi.degree_distribution(jnp.asarray(nbrs))
    for a in (None, alive):
        assert graph_index.in_degree_distribution(t, a) == \
            jgi.in_degree_distribution(jnp.asarray(nbrs), a)
        np.testing.assert_array_equal(graph_index.hub_vertices(t, 64, a).numpy(),
                                      np.asarray(jgi.hub_vertices(jnp.asarray(nbrs), 64, a)))
    padded = graph_index.pad_neighbors(t[:, :5], 9)
    np.testing.assert_array_equal(padded.numpy(),
                                  np.asarray(jgi.pad_neighbors(jnp.asarray(nbrs[:, :5]), 9)))
    assert graph_index.memory_bytes(t) == nbrs.nbytes


def test_lid_mle_agrees_statistically():
    """The sample is drawn from a torch.Generator, so the estimate is held
    to within 10% of the reference's on the same points."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3000, 6), dtype=np.float32)
    got = lid.lid_mle(_t(x), k=20, sample=400, seed=1)
    want = float(jlid.lid_mle(jnp.asarray(x), k=20, sample=400,
                              key=jax.random.PRNGKey(1)))
    assert abs(got - want) < 0.1 * want, (got, want)
