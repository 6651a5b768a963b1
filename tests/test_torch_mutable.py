"""Streaming mutation: the port's ``core.mutable`` against live calls into
``repro.core.mutable``, on the CPU.

The port holds the reference's contracts on its own results:

* exact-mode inserts (``construct="incremental", insert_ef=0``) equal the
  port's exact build bit for bit, across capacity doublings too, with the
  reference's ids;
* ``compact(spec, seed)`` equals ``build_index(survivors, spec, seed)`` bit
  for bit;
* tombstoned and unallocated ids never answer under exact/device,
  pq/device, pq/host, pq/disk and sq8/disk, and an all-zero bitmap is a
  bitwise no-op;
* the disk tier answers as the device does through insert, delete and
  compact;
* metadata columns follow inserts, filters, compaction and a checkpoint.

Against the reference, on its own fixture (N=500, D=16 uniform, NN-Descent
+ GD k=12; 40 inserts at ``insert_ef=24``): its state carried across by
``convert.mutable_from_numpy`` and its entry draws injected, the port's
adjacency after the inserts has the reference's ids (a row may differ only
at a float32 near-tie, counted with float64 distances, at most 1% of rows)
and its edge distances agree within rtol 1e-6, atol 1e-6 (float32 sums
taken in another order: the largest gap seen is 2.4e-7). The inline GD and
DPG selects keep the reference's candidates. The exact scan's distances,
in the distance matrix's expanded l2 form, agree within rtol 1e-5, atol
1e-5 (the cancellation in |x|^2 - 2 x.y + |y|^2: the largest gap seen is
2.4e-6), as do the exact builds' edge distances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bruteforce as jbrute
from repro.core import mutable as jmut
from repro.core.beam_search import random_entries as jrandom_entries
from repro.core.build import BuildSpec as JBuildSpec
from repro.core.build import build_index as jbuild_index
from repro.core.engine import SearchSpec as jengine_spec
from repro_torch.core import bruteforce, convert
from repro_torch.core import diversify as pdiv
from repro_torch.core import io as pio
from repro_torch.core import mutable as pmut
from repro_torch.core.build import BuildSpec, build_index
from repro_torch.core.engine import Searcher, SearchSpec
from repro_torch.core.filters import FilterSpec
from repro_torch.core.graph_index import hub_vertices, in_degree, in_degree_distribution
from repro_torch.core.mutable import MutableIndex, pack_tombstones
from repro_torch.core.topk import INVALID
from repro_torch.launch import serve
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, D = 500, 16
SEED = 3
DIST_TOL = dict(rtol=1e-6, atol=1e-6)
# the expanded l2 form (|x|^2 - 2 x.y + |y|^2) of the distance matrix
MATRIX_TOL = dict(rtol=1e-5, atol=1e-5)
NEAR_TIE_REL = 1e-5
NEAR_TIE_ROWS_MAX = 0.01
BUILD = dict(construct="nndescent", diversify="gd", graph_k=12, nd_rounds=8,
             proxy_sample=0, lid_sample=0)
SCORER_PLACEMENTS = [("exact", "device"), ("pq", "device"), ("pq", "host"),
                     ("pq", "disk"), ("sq8", "disk")]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def points():
    """The reference's fixture: N x D uniform from PRNGKey(3), and the 40
    points its history inserts."""
    key = jax.random.PRNGKey(3)
    base = np.asarray(jax.random.uniform(key, (N, D)), np.float32)
    extra = np.asarray(jax.random.uniform(jax.random.fold_in(key, 7), (40, D)), np.float32)
    return base, extra, key


@pytest.fixture(scope="module")
def port_built(points):
    base, _, _ = points
    spec = BuildSpec(**BUILD)
    return build_index(_t(base), spec, seed=SEED), spec


@pytest.fixture(scope="module")
def ref_built(points):
    base, _, key = points
    return jbuild_index(jnp.asarray(base), JBuildSpec(**BUILD), key)


def _mutate(points, port_built):
    """One insert + delete history over the port's beam-maintained GD
    index (the port's own entry draws)."""
    base, extra, _ = points
    result, spec = port_built
    midx = MutableIndex.from_build(_t(base), result, rng_seed=SEED, insert_ef=24,
                                   diversify="gd")
    new_ids = midx.insert_batch(extra)
    dead = np.random.default_rng(0).choice(N, size=N // 5, replace=False)
    midx.delete(dead)
    return midx, spec, dead, new_ids


@pytest.fixture(scope="module")
def mutated(points, port_built):
    return _mutate(points, port_built)


def _ref_state(jm) -> dict:
    """A reference MutableIndex's state in ``MutableIndex.state()``'s layout."""
    st = {k: np.array(getattr(jm, a)) for k, a in
          (("base", "_base"), ("neighbors", "_nbrs"), ("dists", "_dists"),
           ("alive", "_alive"), ("tombstones", "_tomb"))}
    st["metadata"] = {k: np.array(v) for k, v in jm._meta.items()}
    st.update({k: getattr(jm, k) for k in MutableIndex.STATE_COUNTS})
    return st


def _carried(jm, **kw) -> MutableIndex:
    return convert.mutable_from_numpy(
        _ref_state(jm), metric=jm.metric, insert_ef=jm.insert_ef, diversify=jm.diversify,
        max_keep=jm.max_keep, n_entries=jm.n_entries, device="cpu", **kw)


def _ref_entries(jm, i: int) -> np.ndarray:
    """The entries the reference's i-th insert draws (after its growth)."""
    cap = jm.capacity * (2 if jm.n_alloc == jm.capacity else 1)
    return np.asarray(jrandom_entries(jax.random.fold_in(jm.key, 0x1475 + i), cap, 1,
                                      min(jm.n_entries, jm.insert_ef)))[0]


def _near_tie(base64, rows_a, rows_b, v, vec) -> bool:
    """Row ``v`` (vertex vector ``vec``) differs between two histories only
    at a float32 near-tie: an id kept in one row and not the other has a
    float64 distance (to ``vec``, or to another id of either row, the GD
    occlusion test) within NEAR_TIE_REL of a distance it was compared
    against."""
    a, b = set(rows_a[v].tolist()) - {INVALID}, set(rows_b[v].tolist()) - {INVALID}
    odd, every = sorted(a ^ b), sorted(a | b)

    def d(p, q):
        return float(((p - q) ** 2).sum())
    for c in odd:
        dc = d(vec, base64[c])
        for o in every:
            if o == c:
                continue
            for other in (d(vec, base64[o]), d(base64[o], base64[c])):
                if abs(other - dc) <= NEAR_TIE_REL * max(dc, other):
                    return True
    return False


# -- exact mode -----------------------------------------------------------------


def test_incremental_insert_ef0_bit_matches_exact_build(points):
    """construct="incremental", insert_ef=0 equals construct="exact" bit for
    bit (both directions of the scan through the 128-row block; MKL's
    one-row path sums in another order), and has the reference's ids."""
    base, _, key = points
    kw = dict(diversify="none", graph_k=12, proxy_sample=0, lid_sample=0)
    inc = build_index(_t(base), BuildSpec(construct="incremental", insert_ef=0, **kw), SEED)
    bat = build_index(_t(base), BuildSpec(construct="exact", **kw), SEED)
    assert torch.equal(inc.graph.neighbors, bat.graph.neighbors)
    assert torch.equal(inc.graph.dists, bat.graph.dists)
    assert torch.equal(hub_vertices(inc.graph.neighbors), hub_vertices(bat.graph.neighbors))
    assert inc.report.inserts == N and inc.report.insert_rate > 0
    assert bat.report.inserts == 0 and bat.report.insert_rate == -1.0
    ref = jbuild_index(jnp.asarray(base),
                       JBuildSpec(construct="incremental", insert_ef=0, **kw), key)
    np.testing.assert_array_equal(inc.graph.neighbors.numpy(), np.asarray(ref.graph.neighbors))
    np.testing.assert_allclose(inc.graph.dists.numpy(), np.asarray(ref.graph.dists),
                               **MATRIX_TOL)


def test_exact_maintenance_survives_capacity_growth():
    """Exact-mode inserts across two doublings (capacity 16 -> 64) equal the
    exact k-NN graph of the final points, bit for bit, with the reference's
    ids; the metadata columns grow with the capacity."""
    key = jax.random.PRNGKey(5)
    pts = np.asarray(jax.random.uniform(key, (40, 8)), np.float32)
    midx = MutableIndex.empty(8, 6, capacity=16, insert_ef=0, device="cpu")
    midx.insert_batch(pts)
    assert midx.capacity == 64 and midx.n_live == 40
    assert midx.tombstones.shape == (2,) and midx.tombstones.dtype == torch.int32
    g = bruteforce.exact_knn_graph(_t(pts), 6)
    np.testing.assert_array_equal(midx.neighbors, g.neighbors.numpy())
    np.testing.assert_array_equal(midx.dists, g.dists.numpy())
    np.testing.assert_array_equal(midx.neighbors,
                                  np.asarray(jbrute.exact_knn_graph(jnp.asarray(pts), 6).neighbors))
    tagged = MutableIndex.empty(8, 6, capacity=16, insert_ef=0, device="cpu",
                                metadata={"tenant": np.zeros(0, np.int32)})
    tagged.insert_batch(pts[:20], metadata={"tenant": np.arange(20, dtype=np.int32)})
    assert tagged.capacity == 32 and tagged._meta["tenant"].shape == (32,)
    np.testing.assert_array_equal(tagged.metadata["tenant"], np.arange(20))
    assert (tagged._meta["tenant"][20:] == -1).all()


def test_exact_scan_matches_reference(points):
    """The exact scan: the reference's distances within tolerance in both
    directions, dead rows +inf in both packages."""
    base, extra, _ = points
    alive = np.ones(N, bool)
    alive[::7] = False
    x = extra[0]
    jf, jr = jmut._exact_scan(jnp.asarray(x), jnp.asarray(base), jnp.asarray(alive), "l2")
    pf, pr = pmut._exact_scan(_t(x), _t(base), torch.from_numpy(alive), "l2")
    for got, want in ((pf, jf), (pr, jr)):
        np.testing.assert_array_equal(np.isinf(got.numpy()), ~alive)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MATRIX_TOL)


@pytest.mark.parametrize("select", ["gd", "dpg"])
def test_inline_select_keeps_the_reference_candidates(points, select):
    """One insert's inline GD / DPG select over the same candidates (padding
    included) keeps what the reference's keeps."""
    base, extra, _ = points
    x = extra[3]
    d2 = ((base - x) ** 2).sum(1)
    cand = np.argsort(d2, kind="stable")[:24].astype(np.int32)
    cd = d2[cand].astype(np.float32)
    cand[-3:], cd[-3:] = INVALID, np.inf
    valid = cand >= 0
    if select == "gd":
        want = jmut._gd_select(jnp.asarray(base), jnp.asarray(cand), jnp.asarray(cd),
                               jnp.asarray(valid), metric="l2", max_keep=6)
        got = pmut._gd_select(_t(base), cand, cd, valid, "l2", 6)
    else:
        want = jmut._dpg_select(jnp.asarray(base), jnp.asarray(x), jnp.asarray(cand),
                                jnp.asarray(valid), max_keep=6)
        got = pmut._dpg_select(_t(base), _t(x), cand, valid, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert 1 <= got.sum() <= 6 and not got[~valid].any()


# -- against the reference's history --------------------------------------------


@pytest.mark.parametrize("diversify", ["gd", "dpg", "none"])
def test_beam_inserts_match_the_reference_adjacency(points, ref_built, diversify):
    """The reference's index carried across, then the same 40 inserts in both
    packages with the reference's entry draws injected into the port: the
    same adjacency ids (near-tie rows counted, at most 1%), edge distances
    within tolerance, the same capacity and counters."""
    base, extra, key = points
    jm = jmut.MutableIndex.from_build(base, ref_built, key=key, insert_ef=24,
                                      diversify=diversify)
    pm = _carried(jm)
    entries = []
    for i, x in enumerate(extra):
        entries.append(_ref_entries(jm, i))
        jm.insert(x)
    new_ids = pm.insert_batch(extra, entries=np.stack(entries))
    np.testing.assert_array_equal(new_ids, np.arange(N, N + 40))
    assert (pm.capacity, pm.n_alloc, pm.total_inserts) == (jm.capacity, jm.n_alloc, 40)
    ours, theirs = pm.neighbors, np.asarray(jm.neighbors)
    differ = np.nonzero((ours != theirs).any(1))[0]
    base64 = np.asarray(pm.base, np.float64)
    ties = [v for v in differ if _near_tie(base64, ours, theirs, v, base64[v])]
    assert len(ties) == len(differ), f"rows {sorted(set(differ) - set(ties))} differ"
    assert len(differ) <= NEAR_TIE_ROWS_MAX * pm.n_alloc
    same = np.setdiff1d(np.arange(pm.n_alloc), differ)
    np.testing.assert_allclose(pm.dists[same], jm._dists[: jm.n_alloc][same], **DIST_TOL)


def test_reference_state_carries_across(points, ref_built):
    """convert.mutable_from_numpy takes a reference history mid-way (inserts
    and deletes): every array and counter as the reference's, the
    tombstones as its uint32 words (int32 on the device), and the port
    continues it: no dead id answers; ``state`` / ``from_state`` round-trip."""
    base, extra, key = points
    jm = jmut.MutableIndex.from_build(base, ref_built, key=key, insert_ef=24, diversify="gd",
                                      metadata={"tenant": np.arange(N, dtype=np.int32) % 3})
    jm.insert_batch(extra[:10], metadata={"tenant": np.full(10, 1, np.int32)})
    dead = np.arange(0, N, 9)
    jm.delete(dead)
    pm = _carried(jm)
    st = pm.state()
    for name, want in _ref_state(jm).items():
        if isinstance(want, dict):
            assert st[name].keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(st[name][k], want[k])
        else:
            np.testing.assert_array_equal(st[name], want)
    assert convert.bitmap_to_uint32(pm.tombstones).tolist() == np.asarray(jm._tomb).tolist()
    assert (pm.n_live, pm.n_dead, pm.staleness) == (jm.n_live, jm.n_dead, jm.staleness)
    again = MutableIndex.from_state(st, insert_ef=24, diversify="gd", device="cpu")
    for name in MutableIndex.STATE_ARRAYS:
        np.testing.assert_array_equal(again.state()[name], st[name])
    pm.insert_batch(extra[10:20], metadata={"tenant": np.full(10, 2, np.int32)})
    res = pm.search(_t(extra[20:36]), SearchSpec(ef=48, k=8), seed=4)
    ids = res.ids.numpy()
    assert (ids >= 0).any() and not np.isin(ids[ids >= 0], dead).any()
    assert pm.metadata["tenant"][-10:].tolist() == [2] * 10


# -- compaction, tombstones and search ------------------------------------------


def test_compact_bit_matches_fresh_build_of_survivors(points, port_built):
    midx, spec, dead, _ = _mutate(points, port_built)
    survivors = midx.base[midx.alive].copy()
    n_alloc_pre = midx.n_alloc
    cres = midx.compact(spec, seed=9)
    fresh = build_index(_t(survivors), spec, seed=9)
    assert torch.equal(cres.graph.neighbors, fresh.graph.neighbors)
    np.testing.assert_array_equal(midx.neighbors, fresh.graph.neighbors.numpy())
    np.testing.assert_array_equal(midx.base, survivors)
    assert midx.n_dead == 0 and midx.version == 1 and midx.staleness == 0.0
    assert midx.inserts_since_compact == 0 and midx.log == []
    id_map = midx.last_id_map
    assert (id_map[dead] == INVALID).all()
    live_old = np.nonzero(id_map != INVALID)[0]
    np.testing.assert_array_equal(id_map[live_old], np.arange(survivors.shape[0]))
    assert live_old.shape[0] == n_alloc_pre - dead.shape[0]
    assert cres.report.inserts == 40 and cres.report.staleness > 0
    assert cres.report.insert_rate > 0
    # the diversified graph's NaN distances were recomputed for the links
    assert np.isfinite(midx.dists[midx.neighbors >= 0]).all()


@pytest.mark.parametrize("scorer,placement", SCORER_PLACEMENTS,
                         ids=[f"{s}-{p}" for s, p in SCORER_PLACEMENTS])
def test_tombstoned_ids_never_served(points, mutated, scorer, placement):
    """No answer names a deleted vertex or an unallocated slot, under the
    exact scorer and the compressed scorers on every placement."""
    base, _, key = points
    midx, _spec, dead, _ = mutated
    queries = np.asarray(jax.random.uniform(jax.random.fold_in(key, 2), (16, D)), np.float32)
    sspec = SearchSpec(ef=48, k=8, entry="random", scorer=scorer,
                       base_placement=placement, pq_m=4, pq_k=16)
    searcher = midx.searcher()
    try:
        res = searcher.search(_t(queries), sspec, seed=4)
    finally:
        for store in searcher._stores.values():
            store.close()
        searcher._stores.clear()
    ids = res.ids.numpy()
    assert (ids != INVALID).any(), "searches returned nothing at all"
    assert not np.isin(ids[ids != INVALID], dead).any()
    assert ids.max() < midx.n_alloc


def test_disk_tier_full_mutable_lifecycle(points, port_built):
    """The disk tier answers as the device does (ids, dists, n_comps) under
    pq through insert -> delete -> compact, and denies dead ids on disk."""
    base, _, key = points
    midx, spec, dead, _ = _mutate(points, port_built)
    queries = _t(np.asarray(jax.random.uniform(jax.random.fold_in(key, 21), (12, D))))
    sspec = SearchSpec(ef=32, k=4, entry="random", scorer="pq", pq_m=4, pq_k=16)

    def disk_matches_device(s):
        dev = s.search(queries, sspec, seed=22)
        dsk = s.search(queries, sspec._replace(base_placement="disk"), seed=22)
        assert torch.equal(dev.ids, dsk.ids) and torch.equal(dev.dists, dsk.dists)
        assert torch.equal(dev.n_comps, dsk.n_comps)
        assert (dsk.bytes_touched > 0).all()
        s.base_store("disk").close()
        return dsk.ids.numpy()

    ids = disk_matches_device(midx.searcher())
    assert not np.isin(ids[ids != INVALID], dead).any()
    midx.compact(spec, seed=23)
    disk_matches_device(midx.searcher())


def test_all_zero_tombstone_bitmap_is_identity(points):
    base, _, key = points
    g = bruteforce.exact_knn_graph(_t(base), 12)
    plain = Searcher(_t(base), g.neighbors, rng_seed=SEED)
    zeros = Searcher(_t(base), g.neighbors, rng_seed=SEED,
                     tombstones=convert.bitmap_from_uint32(pack_tombstones(np.zeros(N, bool)),
                                                           "cpu"))
    queries = _t(np.asarray(jax.random.uniform(jax.random.fold_in(key, 2), (8, D))))
    sspec = SearchSpec(ef=32, k=4, entry="random")
    a, b = plain.search(queries, sspec, seed=5), zeros.search(queries, sspec, seed=5)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
    assert torch.equal(a.n_comps, b.n_comps) and int(a.n_steps) == int(b.n_steps)


def test_delete_semantics(points):
    """Deletes as the reference's: counts and staleness, KeyError on a dead,
    unallocated or repeated id after the ids before it are deleted (the
    same alive mask as the reference's after the same calls)."""
    base, _, key = points
    g = bruteforce.exact_knn_graph(_t(base), 8)
    midx = MutableIndex(base, g.neighbors, rng_seed=SEED, device="cpu")
    jm = jmut.MutableIndex(base, g.neighbors.numpy(), key=key)
    for m in (midx, jm):
        m.delete([3, 5])
    assert midx.n_live == N - 2 and midx.n_dead == 2
    assert midx.staleness == pytest.approx(2 / (N - 2))
    for bad in (3, N + 100, -1, [7, 8, 7, 9], [10, N]):
        for m in (midx, jm):
            with pytest.raises(KeyError):
                m.delete(bad)
        np.testing.assert_array_equal(midx.alive, jm.alive)
        assert midx.n_live == jm.n_live and midx.log == jm.log
    assert not midx.alive[[3, 5, 7, 8, 10]].any() and midx.alive[9]
    assert convert.bitmap_to_uint32(midx.tombstones).tolist() == np.asarray(jm._tomb).tolist()
    assert not midx._alive_dev[[3, 5, 7, 8, 10]].any() and bool(midx._alive_dev[9])


def test_in_degree_and_hubs_mask_tombstones():
    nbrs = np.array([[1, 2], [2, 3], [1, -1], [1, 2]], np.int32)
    alive = np.array([True, True, True, False])
    np.testing.assert_array_equal(in_degree(nbrs, alive), [0, 2, 2, 0])
    np.testing.assert_array_equal(in_degree(nbrs), [0, 3, 3, 1])
    hubs = hub_vertices(nbrs, 4, alive=alive).numpy()
    assert 3 not in hubs and set(hubs.tolist()) == {0, 1, 2}
    assert in_degree_distribution(nbrs, alive)["max"] == 2


def test_hub_shortlist_on_20pct_deleted_graph(mutated):
    midx, _spec, dead, _ = mutated
    hubs = hub_vertices(midx.neighbors, 64, alive=midx.alive).numpy()
    assert hubs.shape[0] == 64 and not np.isin(hubs, dead).any()
    s = midx.searcher()
    np.testing.assert_array_equal(s.hubs.numpy(), hubs)
    assert s is midx.searcher()   # cached until the next mutation
    res = s.search(_t(midx.base[:8]), SearchSpec(ef=32, k=4, entry="hubs"), seed=1)
    ids = res.ids.numpy()
    assert not np.isin(ids[ids >= 0], dead).any()


def test_insert_is_searchable_immediately(points):
    base, _, key = points
    g = bruteforce.exact_knn_graph(_t(base), 12)
    midx = MutableIndex(base, g.neighbors, rng_seed=SEED, insert_ef=32, device="cpu")
    x = np.asarray(jax.random.uniform(jax.random.fold_in(key, 11), (D,)), np.float32)
    new_id = midx.insert(x)
    assert new_id == N
    res = midx.search(_t(x[None, :]), SearchSpec(ef=48, k=1, entry="random"), seed=12)
    assert int(res.ids[0, 0]) == new_id
    st = midx.stats()
    assert st["pending_inserts"] == 1 and midx.insert_rate > 0
    assert st["insert_ms"]["beam"] > 0 and st["insert_ms"]["scan"] == 0
    with pytest.raises(ValueError, match=r"\(16,\) point"):
        midx.insert(x[:4])
    with pytest.raises(ValueError, match="inline diversify"):
        MutableIndex(base, g.neighbors, diversify="hnsw", device="cpu")


# -- metadata and checkpoints ----------------------------------------------------


def test_mutable_metadata_lifecycle(tmp_path):
    """Inserts carry metadata (an undeclared column raises), a tenant filter
    excludes other tenants AND dead rows, compaction keeps the columns
    aligned, and checkpoint -> load_index -> from_artifact round-trips
    them, with the graph and the key."""
    rng = np.random.default_rng(3)
    n0, d = 300, 16
    base = rng.random((n0, d), dtype=np.float32)
    meta = {"tenant": rng.integers(0, 3, size=n0).astype(np.int32)}
    bspec = BuildSpec(**BUILD)
    result = build_index(_t(base), bspec, seed=6)
    midx = MutableIndex.from_build(_t(base), result, rng_seed=6, insert_ef=24, metadata=meta)
    extra = rng.random((20, d), dtype=np.float32)
    new_ids = midx.insert_batch(extra, metadata={"tenant": np.full(20, 1, np.int32)})
    with pytest.raises(ValueError, match="declare"):
        midx.insert(extra[0], metadata={"color": 3})

    dead = [int(i) for i in new_ids[:5]]
    midx.delete(dead)
    res = midx.search(_t(base[:16]), SearchSpec(ef=48, k=8, filter=FilterSpec(tenant=1)),
                      seed=9)
    ids = res.ids.numpy()
    valid = ids >= 0
    assert valid.any() and (midx.metadata["tenant"][ids[valid]] == 1).all()
    assert not np.isin(ids[valid], dead).any()

    n_alloc = midx.n_alloc
    midx.compact(bspec, seed=2)
    surv = midx.metadata["tenant"]
    assert surv.shape[0] == n_alloc - len(dead) and (surv >= 0).all()
    np.testing.assert_array_equal(surv[-15:], np.ones(15))

    path, cres = midx.checkpoint(str(tmp_path / "ck"), bspec, seed=8)
    art = pio.load_index(path)
    assert art.provenance["mutable_version"] == midx.version == 2
    midx2 = MutableIndex.from_artifact(art, device="cpu")
    np.testing.assert_array_equal(midx2.metadata["tenant"], midx.metadata["tenant"])
    np.testing.assert_array_equal(midx2.neighbors, midx.neighbors)
    np.testing.assert_array_equal(midx2.base, midx.base)
    np.testing.assert_array_equal(midx2.dists, midx.dists)
    assert midx2.rng_seed == 6 and cres.report.inserts == 0


# -- the build and serve entry points -------------------------------------------


def test_serve_build_construct_incremental(monkeypatch, capsys):
    """``serve --build-construct incremental`` builds through
    ``build_searcher``: every point inserted with GD per insert (no global
    diversify stage), and the served recall close to NN-Descent + GD's."""
    monkeypatch.setattr(serve, "SMOKE_WORLD", (600, 8))
    args = ["--arch", "ann", "--smoke", "--device", "cpu", "--batch", "16", "--batches", "2"]
    inc = serve.serve_ann(serve.parser().parse_args(args + ["--build-construct",
                                                            "incremental"]))
    rep = inc.build.report
    assert rep.spec.construct == "incremental" and rep.spec.diversify == "gd"
    assert rep.inserts == 600 and rep.insert_rate > 0 and rep.wall_diversify_s < 0.05
    assert "incremental construct: 600 inserts" in capsys.readouterr().out
    assert rep.degree["max"] <= 20 and rep.degree["mean"] > 4
    base = inc.searcher.base
    _, res2 = serve.build_searcher(base, construct="incremental", seed=0)
    assert torch.equal(res2.graph.neighbors, inc.build.graph.neighbors)
    nd = serve.serve_ann(serve.parser().parse_args(args))
    assert inc.summary["recall@10"] >= nd.summary["recall@10"] - 0.1


def test_serve_diversify_dpg_builds_through_dpg_prune(monkeypatch):
    """``--diversify dpg`` (offered as the reference offers it) runs the
    port's ``dpg_prune`` once over the NN-Descent graph."""
    monkeypatch.setattr(serve, "SMOKE_WORLD", (600, 8))
    calls = []
    real = pdiv.dpg_prune

    def counted(*a, **kw):
        calls.append(a[1].neighbors.shape)
        return real(*a, **kw)
    monkeypatch.setattr(pdiv, "dpg_prune", counted)
    run = serve.serve_ann(serve.parser().parse_args(
        ["--arch", "ann", "--smoke", "--device", "cpu", "--batch", "16", "--batches", "1",
         "--diversify", "dpg"]))
    assert calls == [(600, 20)]
    assert run.build.report.spec.diversify == "dpg" and run.summary["recall@10"] > 0.5
    with pytest.raises(SystemExit):
        serve.parser().parse_args(["--arch", "ann", "--diversify", "rng"])


# -- the Searcher from searcher() is a snapshot -----------------------------------

SNAP_N, SNAP_CAPACITY, SNAP_INSERTS = 1500, 4000, 200


@pytest.fixture(scope="module")
def snap_points():
    """A 1,500 x 16 normal world, 32 queries and 200 points to insert; the
    capacity (4,000) holds every insert, so no growth replaces the mirrors."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((SNAP_N, D), dtype=np.float32),
            rng.standard_normal((32, D), dtype=np.float32),
            rng.standard_normal((SNAP_INSERTS, D), dtype=np.float32))


def _snap_index(base):
    result = build_index(_t(base), BuildSpec(**BUILD), seed=0)
    return MutableIndex.from_build(_t(base), result, capacity=SNAP_CAPACITY, insert_ef=32,
                                   diversify="gd")


def _same_result(a, b):
    for f in ("ids", "dists", "n_comps", "n_steps"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("scorer", ["exact", "sq8"])
def test_searcher_is_a_snapshot(snap_points, scorer):
    """A Searcher taken before 200 inserts and the deletion of its own top-1
    answers answers bit for bit as before (its mirrors are cloned on the
    next write, once each); searcher() with no mutation since copies
    nothing, and inserts with no searcher() between them clone nothing."""
    base, queries, extra = snap_points
    midx = _snap_index(base)
    s = midx.searcher()
    assert midx.searcher() is s and midx.cow_clones == 0
    held = [t.clone() for t in (s.base, s.neighbors, s.tombstones)]
    spec = s.spec(ef=32, k=4, scorer=scorer)
    before = s.search(_t(queries), spec, 5)
    midx.insert_batch(extra)
    top1 = np.unique(before.ids[:, 0].numpy())
    midx.delete(top1[top1 >= 0])
    after = s.search(_t(queries), spec, 5)
    _same_result(after, before)
    for t, h in zip((s.base, s.neighbors, s.tombstones), held):
        assert torch.equal(t, h)
    mirrors = (midx._base_dev, midx._nbrs_dev, midx._tomb_dev)
    assert midx.cow_clones == 3
    assert midx.cow_bytes == sum(t.numel() * t.element_size() for t in mirrors)
    s2 = midx.searcher()
    midx.insert_batch(extra[:5])            # clones the three mirrors once more
    midx.insert_batch(extra[5:10])          # no searcher() since: clones nothing
    assert midx.cow_clones == 6
    assert s2.base is not midx._base_dev and s2.base[:SNAP_N].equal(midx._base_dev[:SNAP_N])


def test_new_searcher_sees_the_mutations(snap_points):
    """A searcher() taken after the mutations sees them: no deleted id
    answers, and an inserted point finds itself."""
    base, queries, extra = snap_points
    midx = _snap_index(base)
    s0 = midx.searcher()
    spec = s0.spec(ef=32, k=4)
    top1 = np.unique(s0.search(_t(queries), spec, 5).ids[:, 0].numpy())
    dead = top1[top1 >= 0]
    new_ids = midx.insert_batch(extra)
    midx.delete(dead)
    s1 = midx.searcher()
    res = s1.search(_t(queries), spec, 5)
    assert not np.isin(res.ids.numpy(), dead).any()
    own = s1.search(_t(extra[:32]), spec, 6)
    np.testing.assert_array_equal(own.ids[:, 0].numpy(), new_ids[:32])
    np.testing.assert_array_equal(own.dists[:, 0].numpy(), 0.0)


def test_reference_searcher_snapshot(snap_points):
    """The same steps through the live reference. Its device mirrors of the
    base, the adjacency and the tombstone words are ``jnp.asarray`` of host
    arrays (``src/repro/core/mutable.py``: ``_push_all_device``) that later
    inserts and deletes write in place before they replace the mirror. On
    jax's CPU backend ``jnp.asarray`` sometimes adopts the host buffer
    without a copy (when it is aligned), and then the old Searcher sees
    every later write to that array. Adoption is detected per array, by
    its buffer's address against the host array's. Each array that was
    copied is held unchanged; the answers are held only where none of the
    three was adopted."""
    base, queries, extra = snap_points
    key = jax.random.PRNGKey(0)
    jr = jbuild_index(jnp.asarray(base), JBuildSpec(**BUILD), key)
    jm = jmut.MutableIndex.from_build(base, jr, key=key, capacity=SNAP_CAPACITY,
                                      insert_ef=32, diversify="gd")
    js = jm.searcher()
    mirrors = {"base": (js.base, jm._base), "neighbors": (js.neighbors, jm._nbrs),
               "tombstones": (js.tombstones, jm._tomb)}
    adopted = {name: dev.unsafe_buffer_pointer() == host.ctypes.data
               for name, (dev, host) in mirrors.items()}
    held = {name: np.array(dev) for name, (dev, _) in mirrors.items()}
    spec = jengine_spec(ef=32, k=4)
    before = js.search(jnp.asarray(queries), spec, jax.random.PRNGKey(5))
    jm.insert_batch(extra)
    top1 = np.unique(np.asarray(before.ids[:, 0]))
    jm.delete(top1[top1 >= 0])
    for name, (dev, _) in mirrors.items():
        if not adopted[name]:
            np.testing.assert_array_equal(np.asarray(dev), held[name], err_msg=name)
    if not any(adopted.values()):
        after = js.search(jnp.asarray(queries), spec, jax.random.PRNGKey(5))
        np.testing.assert_array_equal(np.asarray(after.ids), np.asarray(before.ids))
        np.testing.assert_array_equal(np.asarray(after.n_comps), np.asarray(before.n_comps))
