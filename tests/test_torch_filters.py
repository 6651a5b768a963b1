"""Filtered search: the port's ``core.filters`` and the engine's filter
plan against live calls into ``repro``, on the CPU.

``compile_filter`` must give the reference's deny words (compared as
uint32), ``n_allowed``, prefix counts and allowed ids. Given the same
entries, a deny bitmap in ``beam_search`` / ``beam_traverse`` gives the
reference's ids, n_comps and n_steps under ``exact``, ``sq8`` and ``pq``,
and the exact-scan route gives its answers (dists within rtol 1e-5: float32
sums taken in another order). The port's seed redraw hashes the row index
where the reference folds it into a ``jax.random`` key, so it is held to
its contract (no denied seed survives, rows dup-free, a padded row redraws
as a direct one), not to the reference's draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import pq as jpq
from repro.core import beam_search as jbeam
from repro.core import filters as jfilters
from repro.core.engine import Searcher as JSearcher
from repro.core.engine import SearchSpec as JSpec
from repro_torch.core import beam_search, convert, filters
from repro_torch.core.build import BuildSpec, GraphBuilder
from repro_torch.core.engine import Searcher, filtered_brute_cutoff
from repro_torch.core.filters import FilterSpec
from repro_torch.core.topk import INVALID
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, D, NQ = 2000, 16, 24
PQ = dict(pq_m=4, pq_k=32)
DIST_TOL = dict(rtol=1e-5, atol=1e-6)
SCORERS = ["exact", "sq8", "pq"]

FILTERS = {
    "all": FilterSpec(),
    "tenant": FilterSpec(tenant=2),
    "tags": FilterSpec(tags_any=(1, 3)),
    "time_selective": FilterSpec(time_range=(0.1, 0.15)),
    "deny_ids": FilterSpec(deny_ids=(0, 5, 31, 63, 1999)),
    "combined": FilterSpec(tenant=1, tags_any=(0, 2, 4), time_range=(0.2, 0.9)),
    "nothing": FilterSpec(time_range=(2.0, 3.0)),
}


@pytest.fixture(scope="module")
def world():
    """A port build (exact 12-NN + GD + PQ M=4 K=32) with metadata columns
    made from a seed, and the reference's Searcher over the same arrays,
    PQ table and metadata."""
    rng = np.random.default_rng(11)
    base = rng.standard_normal((N, D), dtype=np.float32)
    queries = rng.standard_normal((NQ, D), dtype=np.float32)
    metadata = {"tenant": rng.integers(0, 4, N).astype(np.int32),
                "tag": rng.integers(0, 6, N).astype(np.int32),
                "timestamp": rng.random(N).astype(np.float32)}
    res = GraphBuilder(BuildSpec(construct="exact", graph_k=12, compress="pq", **PQ)).build(
        torch.from_numpy(base), seed=3)
    s = Searcher.from_build(torch.from_numpy(base), res, rng_seed=3)
    s.metadata = metadata
    js = JSearcher(jnp.asarray(base), jnp.asarray(s.neighbors.numpy()),
                   key=jax.random.PRNGKey(2), metadata=metadata,
                   pq=jpq.PQIndex(codebooks=jnp.asarray(res.pq.codebooks.numpy()),
                                  codes=jnp.asarray(res.pq.codes.numpy()), M=4, K=32))
    return base, queries, metadata, s, js


def _jfilter(f: FilterSpec) -> jfilters.FilterSpec:
    return jfilters.FilterSpec(*f)


def _allowed(cf) -> np.ndarray:
    return cf.allowed_ids[:cf.n_allowed].numpy()


def test_pack_unpack_and_bitmap_get_match_reference():
    rng = np.random.default_rng(0)
    for n in (1, 31, 32, 33, 100, 1000):
        bits = rng.random(n) < 0.3
        bits[-1] = True
        words = filters.pack_bitmap(bits)
        np.testing.assert_array_equal(words, jfilters.pack_bitmap(bits))
        np.testing.assert_array_equal(filters.unpack_bitmap(words, n), bits)
        as_int32 = convert.bitmap_from_uint32(words, "cpu")
        np.testing.assert_array_equal(filters.unpack_bitmap(as_int32, n), bits)
        ids = rng.integers(-1, n, size=(3, 17)).astype(np.int32)
        np.testing.assert_array_equal(
            filters.bitmap_get(as_int32, torch.from_numpy(ids)).numpy(),
            np.asarray(jfilters.bitmap_get(jnp.asarray(words), jnp.asarray(ids))))


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_compile_filter_matches_reference(world, name):
    _, _, metadata, _, _ = world
    f = FILTERS[name]
    got = filters.compile_filter(f, metadata, N, device="cpu")
    want = jfilters.compile_filter(_jfilter(f), metadata, N)
    np.testing.assert_array_equal(convert.bitmap_to_uint32(got.deny), np.asarray(want.deny))
    assert got.n_allowed == want.n_allowed
    np.testing.assert_array_equal(got.cum.numpy(), np.asarray(want.cum))
    np.testing.assert_array_equal(got.allowed_ids.numpy(), np.asarray(want.allowed_ids))
    assert got.deny.dtype == torch.int32 and got.cum.dtype == torch.int32


def test_tombstones_compose(world):
    _, _, metadata, _, _ = world
    rng = np.random.default_rng(4)
    dead = np.zeros(N, bool)
    dead[rng.choice(N, 300, replace=False)] = True
    dead[[31, 63]] = True
    words = jfilters.pack_bitmap(dead)
    f = FILTERS["tenant"]
    got = filters.compile_filter(f, metadata, N, dead=convert.bitmap_from_uint32(words, "cpu"),
                                 device="cpu")
    want = jfilters.compile_filter(_jfilter(f), metadata, N, dead=jnp.asarray(words))
    np.testing.assert_array_equal(convert.bitmap_to_uint32(got.deny), np.asarray(want.deny))
    assert got.n_allowed == want.n_allowed
    assert not dead[_allowed(got)].any()
    np.testing.assert_array_equal(got.allowed_ids.numpy(), np.asarray(want.allowed_ids))


def test_missing_column_and_bad_deny_ids_raise_loudly(world):
    _, _, metadata, _, _ = world
    with pytest.raises(ValueError, match="metadata column 'tag'"):
        filters.compile_filter(FilterSpec(tags_any=(1,)), {"tenant": metadata["tenant"]}, N,
                               device="cpu")
    with pytest.raises(ValueError, match="metadata column 'tenant'"):
        filters.compile_filter(FilterSpec(tenant=0), None, N, device="cpu")
    with pytest.raises(ValueError, match="must be"):
        filters.compile_filter(FilterSpec(tenant=0), {"tenant": np.zeros(5)}, N, device="cpu")
    with pytest.raises(ValueError, match="deny_ids must lie"):
        filters.compile_filter(FilterSpec(deny_ids=(N,)), metadata, N, device="cpu")


def _scorer_states(s, js, queries, scorer):
    spec = s.spec(scorer=scorer, **PQ)
    return s.scorer_state(torch.from_numpy(queries), spec), \
        js.scorer_state(jnp.asarray(queries), JSpec(scorer=scorer, **PQ))


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("scorer", SCORERS)
def test_deny_in_beam_search_matches_reference(world, scorer, per_query):
    base, queries, metadata, s, js = world
    words = jfilters.compile_filter(_jfilter(FILTERS["tenant"]), metadata, N).deny
    words = np.asarray(words)
    if per_query:  # a (Q, W) deny: each row its own tenant
        words = np.stack([np.asarray(jfilters.compile_filter(
            jfilters.FilterSpec(tenant=i % 4), metadata, N).deny) for i in range(NQ)])
    entries = np.array(jbeam.random_entries(jax.random.PRNGKey(8), N, NQ, 8))
    ps, jst = _scorer_states(s, js, queries, scorer)
    kw = dict(ef=32, k=5, scorer=scorer)
    want = jbeam.beam_search(jnp.asarray(queries), jnp.asarray(base), js.neighbors,
                             jnp.asarray(entries), scorer_state=jst, deny=jnp.asarray(words), **kw)
    got = beam_search.beam_search(torch.from_numpy(queries), s.base, s.neighbors,
                                  torch.from_numpy(entries), scorer_state=ps,
                                  deny=convert.bitmap_from_uint32(words, "cpu"), **kw)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.n_comps.numpy(), np.asarray(want.n_comps))
    assert int(got.n_steps) == int(want.n_steps)
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), **DIST_TOL)
    tenants = metadata["tenant"][np.maximum(got.ids.numpy(), 0)]
    want_t = (np.arange(NQ) % 4)[:, None] if per_query else 2
    assert ((tenants == want_t) | (got.ids.numpy() < 0)).all()


@pytest.mark.parametrize("scorer", ["sq8", "pq"])
def test_deny_in_beam_traverse_matches_reference(world, scorer):
    _, queries, metadata, s, js = world
    words = np.asarray(jfilters.compile_filter(_jfilter(FILTERS["combined"]), metadata, N).deny)
    entries = np.array(jbeam.random_entries(jax.random.PRNGKey(9), N, NQ, 8))
    ps, jst = _scorer_states(s, js, queries, scorer)
    kw = dict(ef=32, k=5, scorer=scorer)
    want = jbeam.beam_traverse(jnp.asarray(queries), js.neighbors, jnp.asarray(entries),
                               scorer_state=jst, deny=jnp.asarray(words), **kw)
    got = beam_search.beam_traverse(torch.from_numpy(queries), s.neighbors,
                                    torch.from_numpy(entries), scorer_state=ps,
                                    deny=convert.bitmap_from_uint32(words, "cpu"), **kw)
    np.testing.assert_array_equal(got.cand_ids.numpy(), np.asarray(want.cand_ids))
    np.testing.assert_array_equal(got.n_comps.numpy(), np.asarray(want.n_comps))
    assert int(got.n_steps) == int(want.n_steps)


def _allowed_entries(cf, seed, E=8):
    """(NQ, E) dup-free entries drawn from the allowed set only, so the
    seed redraw leaves them as they are (up to the row sort of dedup)."""
    rng = np.random.default_rng(seed)
    allowed = np.asarray(cf.allowed_ids)[:cf.n_allowed]
    return np.stack([rng.choice(allowed, E, replace=False) for _ in range(NQ)]).astype(np.int32)


@pytest.mark.parametrize("scorer,placement", [("exact", "device"), ("sq8", "device"),
                                              ("pq", "device"), ("sq8", "host"),
                                              ("pq", "host"), ("sq8", "disk"), ("pq", "disk")])
def test_filtered_search_matches_reference_given_entries(world, scorer, placement):
    _, queries, _, s, js = world
    f = FILTERS["tags"]
    kw = dict(ef=32, k=5, scorer=scorer, base_placement=placement, **PQ)
    jspec = JSpec(filter=_jfilter(f), **kw)
    ent = _allowed_entries(js.compiled_filter(_jfilter(f)), 1)
    want = js.search(jnp.asarray(queries), jspec, entries=jnp.asarray(ent))
    got = s.search(torch.from_numpy(queries), s.spec(filter=f, **kw),
                   entries=torch.from_numpy(ent))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.n_comps.numpy(), np.asarray(want.n_comps))
    np.testing.assert_array_equal(got.bytes_touched.numpy(), np.asarray(want.bytes_touched))
    assert int(got.n_steps) == int(want.n_steps)
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), **DIST_TOL)


@pytest.mark.parametrize("name", ["time_selective", "nothing"])
def test_filtered_brute_matches_reference(world, name):
    _, queries, _, s, js = world
    f = FILTERS[name]
    spec = s.spec(ef=32, k=5, filter=f)
    cf = s.compiled_filter(f)
    assert cf.n_allowed <= filtered_brute_cutoff(spec)
    got = s._filtered_brute(torch.from_numpy(queries), cf, spec)
    jspec = JSpec(ef=32, k=5, filter=_jfilter(f))
    want = js._filtered_brute(jnp.asarray(queries), js.compiled_filter(_jfilter(f)), jspec)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.n_comps.numpy(), np.asarray(want.n_comps))
    np.testing.assert_array_equal(got.bytes_touched.numpy(), np.asarray(want.bytes_touched))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), **DIST_TOL)
    # the engine takes this route for the whole search, under any placement
    for kw in (dict(), dict(scorer="pq", base_placement="disk", **PQ)):
        via = s.search(torch.from_numpy(queries), s.spec(ef=32, k=5, filter=f, **kw), 4)
        assert torch.equal(via.ids, got.ids) and int(via.n_steps) == 0


def test_remap_denied_seeds_contract(world):
    _, _, metadata, s, _ = world
    cf = s.compiled_filter(FILTERS["tenant"])
    gen = torch.Generator().manual_seed(0)
    entries = torch.randint(0, N, (40, 8), generator=gen, dtype=torch.int32)
    out = filters.remap_denied_seeds(entries, cf, 17)
    valid = out[out >= 0].numpy()
    assert valid.size > 0.8 * out.numel()
    assert (metadata["tenant"][valid] == 2).all()           # no denied seed survives
    for row in out.tolist():
        ok = [i for i in row if i >= 0]
        assert len(ok) == len(set(ok))                      # dup-free rows
    padded = torch.cat([entries[:5], torch.randint(0, N, (11, 8), generator=gen,
                                                   dtype=torch.int32)])
    assert torch.equal(filters.remap_denied_seeds(entries[:5], cf, 17),
                       filters.remap_denied_seeds(padded, cf, 17)[:5])
    assert not torch.equal(out, filters.remap_denied_seeds(entries, cf, 18))
    allowed_only = torch.from_numpy(_allowed_entries(cf, 3)[:6])
    assert torch.equal(filters.remap_denied_seeds(allowed_only, cf, 17),
                       beam_search.dedup_rows(allowed_only))
    empty = s.compiled_filter(FILTERS["nothing"])
    assert torch.equal(filters.remap_denied_seeds(entries, empty, 17), entries)


def test_seed_draws_cover_the_allowed_range():
    d = filters.seed_draws(5, 2000, 8, 37, "cpu")
    assert d.dtype == torch.int32 and int(d.min()) == 0 and int(d.max()) == 36
    counts = torch.bincount(d.flatten().long(), minlength=37).float()
    assert float(counts.min()) > 0.6 * float(counts.mean())


def test_empty_filter_contract(world):
    _, queries, _, s, _ = world
    for kw in (dict(), dict(scorer="pq", base_placement="host", **PQ)):
        res = s.search(torch.from_numpy(queries[:8]),
                       s.spec(ef=32, k=5, filter=FILTERS["nothing"], **kw), 5)
        assert (res.ids == INVALID).all() and not torch.isfinite(res.dists).any()
        assert (res.n_comps == 0).all()


@pytest.mark.parametrize("scorer,placement", [("exact", "device"), ("pq", "device"),
                                              ("pq", "host"), ("sq8", "disk")])
def test_tenant_isolation(world, scorer, placement):
    _, queries, metadata, s, _ = world
    for t in range(4):
        res = s.search(torch.from_numpy(queries),
                       s.spec(ef=32, k=5, scorer=scorer, base_placement=placement,
                              filter=FilterSpec(tenant=t), **PQ), 100 + t)
        ids = res.ids.numpy()
        assert (ids >= 0).all()
        assert (metadata["tenant"][ids] == t).all(), f"tenant {t} leaks under {scorer}/{placement}"


def test_deny_ids_suppress_known_answers(world):
    _, queries, _, s, _ = world
    q = torch.from_numpy(queries)
    spec = s.spec(ef=32, k=5)
    top = s.search(q, spec, 13).ids
    deny = tuple(sorted({int(i) for i in top[:, 0]}))
    res = s.search(q, spec._replace(filter=FilterSpec(deny_ids=deny)), 13)
    assert not np.isin(res.ids.numpy(), np.asarray(deny)).any()


@pytest.mark.parametrize("placement", ["device", "host"])
def test_search_stream_filtered_equals_its_tiles(world, placement):
    from repro_torch.core.engine import _fold

    _, queries, metadata, s, _ = world
    q = torch.from_numpy(queries)
    f = FILTERS["combined"]
    spec = s.spec(ef=32, k=5, scorer="pq", base_placement=placement, filter=f, **PQ)
    tiled = s.search_stream(q, spec, 31, tile_q=10)
    cf = s.compiled_filter(f)
    assert np.isin(tiled.ids.numpy()[tiled.ids.numpy() >= 0], _allowed(cf)).all()
    tile = s.search(q[10:20], spec, _fold(31, 1))
    assert torch.equal(tiled.ids[10:20], tile.ids) and torch.equal(tiled.n_comps[10:20],
                                                                   tile.n_comps)


def test_search_with_trace_filters_and_refuses_the_scan_route(world):
    _, queries, _, s, _ = world
    q = torch.from_numpy(queries)
    res, td, tc = s.search_with_trace(q, s.spec(ef=32, k=5, filter=FILTERS["tenant"],
                                                max_steps=20), 2)
    assert (s.metadata["tenant"][res.ids.numpy()] == 2).all() and td.shape == (20, NQ)
    with pytest.raises(ValueError, match="exact-scan"):
        s.search_with_trace(q, s.spec(ef=32, k=5, filter=FILTERS["time_selective"]))


def test_filter_cache_lru_eviction_and_recompile(world):
    _, queries, _, s, _ = world
    q = torch.from_numpy(queries[:4])
    spec = s.spec(ef=32, k=5)
    old_cap = s.filter_cache_size
    s._filters.clear()
    s.filter_cache_size = 4
    try:
        fs = [FilterSpec(tenant=t % 4, tags_any=(t,)) for t in range(6)]
        before = s.filter_compiles
        for f in fs:
            s.search(q, spec._replace(filter=f), 1)
        assert s.filter_compiles == before + 6
        assert list(s._filters) == fs[2:]                   # oldest two evicted
        s.search(q, spec._replace(filter=fs[2]), 1)         # a hit: no compile
        assert s.filter_compiles == before + 6
        assert next(iter(reversed(s._filters))) == fs[2]
        s.search(q, spec._replace(filter=fs[0]), 1)         # evicted: one compile
        assert s.filter_compiles == before + 7
        assert len(s._filters) == 4 and fs[3] not in s._filters and fs[0] in s._filters
    finally:
        s.filter_cache_size = old_cap
        s._filters.clear()


def test_filter_on_a_searcher_without_metadata_raises(world):
    base, queries, _, s, _ = world
    bare = convert.searcher_from_numpy(base, s.neighbors.numpy(), device="cpu")
    with pytest.raises(ValueError, match="metadata column 'tenant'.*carries \\[\\]"):
        bare.search(torch.from_numpy(queries), bare.spec(filter=FilterSpec(tenant=0)))
    # an explicit denylist needs no metadata
    res = bare.search(torch.from_numpy(queries), bare.spec(
        ef=32, k=3, filter=FilterSpec(deny_ids=tuple(range(0, N, 2)))), 1)
    assert (res.ids.numpy() % 2 == 1).all()
