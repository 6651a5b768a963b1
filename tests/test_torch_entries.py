"""The entry strategies, per-query termination, restarts and the Fig. 6
trace on the port, held against live calls into ``repro`` on the CPU.

Exact holds: given the same inputs (the reference's graph, hub list,
projection or entries), identical ids, n_comps and n_steps, dists within
1e-5 relative. The projection tests first assert that no float32 near-tie
(a gap of 1e-4 or less at the cut) decides which ids are kept. Restart
draws come from another generator than the reference's, so restarts are
held statistically: recall@10 within 0.02 and comps/query within 5% of the
reference's on the same graph and entries. The serve path runs every
entry on a small world and reaches the reference's recall@10 less 0.03.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import lsh as jlsh
from repro.core import beam_search as jbeam
from repro.core import bruteforce as jbrute
from repro.core import diversify as jdiv
from repro.core import engine as jengine
from repro.core import graph_index as jgi
from repro.core.build import BuildSpec as JBuildSpec
from repro.core.build import GraphBuilder as JGraphBuilder
from repro.core.topk import recall_at_k as jrecall
from repro_torch.baselines import lsh
from repro_torch.core import beam_search, build, convert, engine
from repro_torch.core.bruteforce import ground_truth
from repro_torch.core.graph_index import HnswIndex, memory_bytes
from repro_torch.core.topk import recall_at_k
from repro_torch.launch import serve
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, D = 2000, 16
DIST_TOL = dict(rtol=1e-5, atol=1e-6)
TIE_GAP = 1e-4


def _t(a, dtype=torch.float32):
    return convert.tensor(a, dtype, device="cpu")


@pytest.fixture(scope="module")
def world():
    """n=2000, d=16 base, 200 queries, the reference's exact 12-NN graph
    unioned with its reverse edges, its hub list and random entries."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((N, D), dtype=np.float32)
    queries = rng.standard_normal((200, D), dtype=np.float32)
    g = jbrute.exact_knn_graph(jnp.asarray(base), 12)
    nbrs = np.asarray(jdiv.add_reverse_edges(g.neighbors, 16))
    entries = np.asarray(jbeam.random_entries(jax.random.PRNGKey(3), N, 200, 8))
    hubs = np.asarray(jgi.hub_vertices(jnp.asarray(nbrs), 64))
    gt = np.asarray(jbrute.ground_truth(jnp.asarray(queries), jnp.asarray(base), 10))
    return dict(base=base, queries=queries, nbrs=nbrs, entries=entries, hubs=hubs, gt=gt)


def _searchers(w, **kw):
    ref = jengine.Searcher(jnp.asarray(w["base"]), jnp.asarray(w["nbrs"]),
                           hubs=jnp.asarray(w["hubs"]), **kw)
    port = convert.searcher_from_numpy(w["base"], w["nbrs"], hubs=w["hubs"], device="cpu",
                                       **kw)
    return ref, port


def _assert_same(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.n_comps.numpy(), np.asarray(want.n_comps))
    assert int(got.n_steps) == int(want.n_steps)
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), **DIST_TOL)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("hub_count", [32, 16, 80])
def test_hubs_seeder_matches_reference(world, metric, hub_count):
    """The hubs seeder scans the build's hub list (its prefix, or the
    adjacency's top in-degree set where the list is too short): identical
    entries and comps, and the search on from them."""
    jref, port = _searchers(world, metric=metric)
    q = world["queries"][:48]
    spec = dict(ef=32, k=10, entry="hubs", hub_count=hub_count)
    got_e, got_c = port.seed(_t(q), port.spec(**spec))
    want_e, want_c = jref.seed(jnp.asarray(q), jref.spec(**spec))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert (got_c == hub_count).all() and got_e.shape == (48, 8)
    _assert_same(port.search(_t(q), port.spec(**spec)),
                 jref.search(jnp.asarray(q), jref.spec(**spec)))


def _projected(w, proj):
    bp = w["base"].astype(np.float64) @ np.asarray(proj, np.float64)
    qp = w["queries"].astype(np.float64) @ np.asarray(proj, np.float64)
    return ((qp[:, None, :] - bp[None, :, :]) ** 2).sum(-1)


def _assert_no_tie_at(dists: np.ndarray, cut: int):
    srt = np.sort(dists, axis=1)
    gap = srt[:, cut] - srt[:, cut - 1]
    assert gap.min() > TIE_GAP, (cut, gap.min())


def test_projection_entries_match_reference(world):
    """Given the reference's projection: the E nearest in the 8-dim space,
    no tie at the E-th, identical ids; the seeder charges n m / d."""
    proj = jlsh.build_srs(jnp.asarray(world["base"]), m=8, key=jax.random.PRNGKey(5)).proj
    q = world["queries"][:40]
    _assert_no_tie_at(_projected(world, proj)[:40], 8)
    idx = lsh.build_srs(_t(world["base"]), m=8, proj=_t(proj))
    got = beam_search.projection_entries(_t(q), idx.base_proj, idx.proj, 8)
    want = jbeam.projection_entries(jnp.asarray(q), jnp.asarray(world["base"]) @ proj,
                                    proj, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def test_srs_search_matches_reference(world):
    """SRS given the reference's projection: 64 probes in the 8-dim space
    (no tie at the 64th), reranked exactly (no tie at the 8th): identical
    ids and comps, dists within 1e-5."""
    jidx = jlsh.build_srs(jnp.asarray(world["base"]), m=8, key=jax.random.PRNGKey(6))
    q = world["queries"][:40]
    pd = _projected(world, jidx.proj)[:40]
    _assert_no_tie_at(pd, 64)
    cand = np.argsort(pd, axis=1, kind="stable")[:, :64]
    exact = ((q[:, None, :].astype(np.float64) - world["base"][cand]) ** 2).sum(-1)
    _assert_no_tie_at(exact, 8)
    idx = lsh.build_srs(_t(world["base"]), m=8, proj=_t(jidx.proj))
    got_d, got_i, got_c = lsh.srs_search(_t(q), _t(world["base"]), idx, k=8, probes=64)
    want_d, want_i, want_c = jlsh.srs_search(jnp.asarray(q), jnp.asarray(world["base"]),
                                             jidx, k=8, probes=64)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-5)
    assert int(got_c[0]) == N * 8 // D + 64


@pytest.mark.parametrize("entry", ["projection", "lsh"])
def test_projection_and_lsh_seeders_draw_their_own_sketch(world, entry):
    """The seeders prepare an 8-dim sketch from the searcher's seed once
    (cached), give E dup-free in-range entries and charge the reference's
    seed-phase comps; another rng_seed draws another sketch."""
    _, port = _searchers(world)
    spec = port.spec(ef=32, k=10, entry=entry)
    q = _t(world["queries"][:16])
    ent, comps = port.seed(q, spec)
    assert port.prepare(spec) is port.prepare(spec)
    assert ent.shape == (16, 8) and int(ent.min()) >= 0 and int(ent.max()) < N
    assert all(len(set(r)) == 8 for r in ent.tolist())
    assert (comps == N * 8 // D + (64 if entry == "lsh" else 0)).all()
    other = convert.searcher_from_numpy(world["base"], world["nbrs"], rng_seed=1,
                                        device="cpu")
    assert not torch.equal(other.prepare(spec).proj, port.prepare(spec).proj)
    res = port.search(q, spec)
    assert recall_at_k(res.ids, _t(world["gt"][:16], torch.int32)) > 0.9


@pytest.mark.parametrize("metric", ["l2", "cos"])
@pytest.mark.parametrize("stable_steps", [1, 3, 8])
def test_stable_termination_matches_reference(world, metric, stable_steps):
    """term="stable" given entries: identical to the reference (a row
    freezes after stable_steps steps without a top-k improvement)."""
    q, e = world["queries"][:64], world["entries"][:64]
    kw = dict(ef=32, k=10, metric=metric, term="stable", stable_steps=stable_steps)
    got = beam_search.beam_search(_t(q), _t(world["base"]), _t(world["nbrs"], torch.int32),
                                  _t(e, torch.int32), **kw)
    want = jbeam.beam_search(jnp.asarray(q), jnp.asarray(world["base"]),
                             jnp.asarray(world["nbrs"]), jnp.asarray(e), **kw)
    _assert_same(got, want)
    fixed = beam_search.beam_search(_t(q), _t(world["base"]), _t(world["nbrs"], torch.int32),
                                    _t(e, torch.int32), ef=32, k=10, metric=metric)
    assert int(got.n_comps.sum()) <= int(fixed.n_comps.sum())


@pytest.mark.parametrize("term", ["fixed", "stable"])
def test_search_with_trace_matches_reference(world, term):
    """The Fig. 6 trace given entries: both (steps, Q) arrays (dists within
    1e-5, comps identical) and the final result."""
    q, e = world["queries"][:32], world["entries"][:32]
    kw = dict(ef=32, k=10, max_steps=40, term=term, stable_steps=4)
    got, gd, gc = beam_search.search_with_trace(_t(q), _t(world["base"]),
                                                _t(world["nbrs"], torch.int32),
                                                _t(e, torch.int32), **kw)
    want, wd, wc = jbeam.search_with_trace(jnp.asarray(q), jnp.asarray(world["base"]),
                                           jnp.asarray(world["nbrs"]), jnp.asarray(e), **kw)
    assert gd.shape == gc.shape == (40, 32)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **DIST_TOL)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    _assert_same(got, want)
    assert bool((gc[1:] >= gc[:-1]).all()) and bool((gd[1:] <= gd[:-1]).all())


def test_searcher_trace_charges_the_seed_phase(world):
    """Searcher.search_with_trace seeds through the entry strategy (hubs
    here: deterministic) and adds its comps to every trace row, as the
    reference does."""
    jref, port = _searchers(world)
    q = world["queries"][:24]
    spec = dict(ef=32, k=10, entry="hubs", max_steps=30)
    got, gd, gc = port.search_with_trace(_t(q), port.spec(**spec))
    want, wd, wc = jref.search_with_trace(jnp.asarray(q), jref.spec(**spec))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **DIST_TOL)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    _assert_same(got, want)
    assert bool((gc[0] > 32).all())


def test_restarts_hold_the_reference_statistically(world):
    """Restarts from the port's draws against the reference's on the same
    graph and entries (200 queries, ef=16, stable_steps=2, 2 restarts):
    recall@10 within 0.02, comps/query within 5%; restarts cost comps and
    the search is reproducible from its seed."""
    jref, port = _searchers(world)
    q, e = world["queries"], world["entries"]
    kw = dict(ef=16, k=10, term="stable", stable_steps=2, restarts=2)
    want = jref.search(jnp.asarray(q), jref.spec(**kw), jax.random.PRNGKey(9),
                       entries=jnp.asarray(e))
    got = port.search(_t(q), port.spec(**kw), 9, entries=_t(e, torch.int32))
    gt = world["gt"]
    r_got = recall_at_k(got.ids, _t(gt, torch.int32))
    r_want = float(jrecall(want.ids, jnp.asarray(gt)))
    c_got, c_want = float(got.n_comps.float().mean()), float(np.mean(want.n_comps))
    assert abs(r_got - r_want) <= 0.02, (r_got, r_want)
    assert abs(c_got - c_want) <= 0.05 * c_want, (c_got, c_want)
    none = port.search(_t(q), port.spec(**{**kw, "restarts": 0}), 9,
                       entries=_t(e, torch.int32))
    assert c_got > float(none.n_comps.float().mean())
    again = port.search(_t(q), port.spec(**kw), 9, entries=_t(e, torch.int32))
    assert torch.equal(got.ids, again.ids) and torch.equal(got.n_comps, again.n_comps)
    with pytest.raises(ValueError, match="restart_keys"):
        beam_search.beam_search(_t(q), port.base, port.neighbors, _t(e, torch.int32),
                                ef=16, restarts=1)


def test_restart_keys_are_per_row_index(world):
    """Row i's key does not depend on how many rows are drawn; the draws
    are in range, per row, and change with the restart count."""
    _, port = _searchers(world)
    spec = port.spec(restarts=1)
    assert port.restart_keys(8, port.spec()) is None
    k5, k40 = port.restart_keys(5, spec, 7), port.restart_keys(40, spec, 7)
    assert k5.dtype == torch.int64 and torch.equal(k5, k40[:5])
    assert not torch.equal(k5, port.restart_keys(5, spec, 8))
    used = torch.zeros(40, dtype=torch.int32)
    a = beam_search.restart_draws(k40, used, 8, N)
    assert a.dtype == torch.int32 and int(a.min()) >= 0 and int(a.max()) < N
    assert torch.equal(a[:5], beam_search.restart_draws(k5, used[:5], 8, N))
    assert not torch.equal(a, beam_search.restart_draws(k40, used + 1, 8, N))


@pytest.mark.parametrize("entry", ["random", "hubs"])
def test_restarts_survive_a_padded_stream_tile(world, entry):
    """A batch padded into a search_stream tile restarts bit for bit as the
    direct search of its rows with the tile's seed: restart keys are per
    row index, padding rows draw nothing and cost nothing."""
    _, port = _searchers(world)
    spec = port.spec(ef=24, k=10, entry=entry, term="stable", stable_steps=2, restarts=2)
    q = _t(world["queries"][:48])
    res = port.search_stream(q, spec, 7, tile_q=20)
    direct = port.search(q[40:], spec, engine._fold(7, 2))
    assert torch.equal(res.ids[40:], direct.ids)
    assert torch.equal(res.dists[40:], direct.dists)
    assert torch.equal(res.n_comps[40:], direct.n_comps)
    assert res.ids.shape == (48, 10) and bool((res.ids >= 0).all())


def test_hnsw_construct_through_the_graph_builder():
    """construct="hnsw": the bottom layer is the flat graph, the report
    carries per-layer stats and the hierarchy's memory, the Searcher binds
    the hierarchy and the hub list; any diversify stage but none is
    refused."""
    base = _t(np.random.default_rng(2).standard_normal((1200, 12), dtype=np.float32))
    spec = build.BuildSpec(construct="hnsw", diversify="none", graph_k=10, nd_rounds=3,
                           lid_sample=0, n_hubs=16)
    res = build.GraphBuilder(spec).build(base, seed=1)
    idx = res.hierarchy
    assert isinstance(idx, HnswIndex) and idx.num_layers >= 3
    assert torch.equal(res.graph.neighbors, idx.layers_neighbors[0])
    assert res.graph.degree == 2 * 8          # hnsw_m = max(8, graph_k // 2)
    rep = res.report
    assert [layer["nodes"] for layer in rep.layers][0] == 1200
    assert rep.layers[0]["source"] == "bottom_graph" and rep.rounds <= 3
    assert rep.memory_bytes == memory_bytes(idx)
    assert rep.dropped_reverse_edges == sum(la["dropped_reverse_edges"] for la in rep.layers)
    s = engine.Searcher.from_build(base, res)
    assert s.hierarchy is idx and torch.equal(s.hubs, res.hubs)
    out = s.search(base[:8], s.spec(ef=32, k=5, entry="hierarchy"))
    assert torch.equal(out.ids[:, 0], torch.arange(8, dtype=torch.int32))
    for div in ("gd", "dpg"):
        with pytest.raises(ValueError, match="diversify='none'|unknown"):
            build.GraphBuilder(build.BuildSpec(construct="hnsw", diversify=div))
    small = engine.Searcher.build(base[:600], seed=2, spec=spec._replace(n_hubs=64))
    assert small.hierarchy is not None and small.hierarchy.levels.shape == (600,)
    assert small.hubs.shape == (64,)


SERVE_N, SERVE_D, BATCH, BATCHES = 3000, 16, 64, 2
ENTRIES = ["random", "projection", "hierarchy", "lsh", "hubs"]


@pytest.fixture(scope="module")
def reference_recall():
    """The reference's recall@10 on the serve world under each entry: its
    own build (HNSW with no diversify stage for hierarchy, as the serve
    CLI's auto construct; NN-Descent + GD otherwise) and its own draws."""
    base = jnp.asarray(serve.numpy_world(SERVE_N, SERVE_D, 0))
    key = jax.random.PRNGKey(0)
    qs = serve.numpy_queries(SERVE_D, BATCH, BATCHES, 0)
    gt = jbrute.ground_truth(jnp.asarray(np.concatenate(qs)), base, 10)
    out = {}
    for construct in ("nndescent", "hnsw"):
        spec = JBuildSpec(construct=construct,
                          diversify="none" if construct == "hnsw" else "gd")
        searcher = jengine.Searcher.from_build(base, JGraphBuilder(spec).build(base, key=key),
                                               key=key)
        for entry in (["hierarchy"] if construct == "hnsw" else
                      [e for e in ENTRIES if e != "hierarchy"]):
            sp = searcher.spec(ef=64, k=10, entry=entry)
            found = jnp.concatenate([searcher.search(jnp.asarray(q), sp,
                                                     jax.random.fold_in(key, b)).ids
                                     for b, q in enumerate(qs)])
            out[entry] = float(jrecall(found, gt))
    return out


@pytest.mark.parametrize("entry", ENTRIES)
def test_serve_every_entry_reaches_the_reference_recall(reference_recall, entry,
                                                        monkeypatch, capsys):
    """``serve --arch ann --smoke --device cpu --entry X`` on the small
    world: recall@10 at least the reference's less 0.03; the hierarchy
    entry builds HNSW (auto construct) and prints its layer sizes, the
    summary carries the seed phase's comps."""
    monkeypatch.setattr(serve, "SMOKE_WORLD", (SERVE_N, SERVE_D))
    out = serve.serve_ann(serve.parser().parse_args(
        ["--arch", "ann", "--smoke", "--device", "cpu", "--batch", str(BATCH),
         "--batches", str(BATCHES), "--entry", entry])).summary
    want = reference_recall[entry]
    assert out["recall@10"] >= want - 0.03, (out["recall@10"], want)
    assert out["entry"] == entry and out["queries"] == BATCH * BATCHES
    text = capsys.readouterr().out
    assert f"entry={entry}" in text and "seed phase" in text
    if entry == "hierarchy":
        assert "[serve-ann] built hnsw·none·none over n=3000 d=16" in text
        assert "[serve-ann] hnsw layers" in text
        assert out["hnsw_layers"][0] == SERVE_N and len(out["hnsw_layers"]) >= 3
        assert 0 < out["seed_comps_per_query"] < out["comps_per_query"]
    else:
        assert "[serve-ann] built nndescent·gd·none" in text and out["hnsw_layers"] == []
    if entry == "random":
        assert out["seed_comps_per_query"] == 0.0


def test_serve_stable_termination_and_restarts(monkeypatch):
    """``--term stable --stable-steps 4 --restarts 1`` runs through the
    serve path: fewer comps than the classic rule, recall above 0.9."""
    monkeypatch.setattr(serve, "SMOKE_WORLD", (SERVE_N, SERVE_D))
    args = ["--arch", "ann", "--smoke", "--device", "cpu", "--batch", str(BATCH),
            "--batches", str(BATCHES), "--entry", "hubs"]
    fixed = serve.serve_ann(serve.parser().parse_args(args)).summary
    out = serve.serve_ann(serve.parser().parse_args(
        args + ["--term", "stable", "--stable-steps", "4", "--restarts", "1"])).summary
    assert out["term"] == "stable" and out["restarts"] == 1
    assert out["comps_per_query"] < fixed["comps_per_query"]
    assert out["recall@10"] > 0.9
    assert serve.build_stages(serve.parser().parse_args(
        ["--arch", "ann", "--entry", "hierarchy"])) == ("hnsw", "none")
    assert serve.build_stages(serve.parser().parse_args(
        ["--arch", "ann", "--entry", "lsh", "--build-construct", "hnsw"])) == ("hnsw", "none")
    assert serve.build_stages(serve.parser().parse_args(["--arch", "ann"])) == ("nndescent",
                                                                                "gd")
    gt = ground_truth(_t(np.zeros((1, 4), np.float32)), _t(np.eye(4, dtype=np.float32)), 1)
    assert gt.shape == (1, 1)
