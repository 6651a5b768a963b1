"""The tiered base store: the port's ``core.base_store`` and the engine's
host and disk placements against live calls into ``repro``, on the CPU.

Gathered rows and billed bytes must equal the reference's ``BaseStore``
(host rows at row_bytes each, disk rows in whole deduplicated 4 KiB pages,
shards of unequal rows, f32 rows of d = 1,100 that straddle pages). Host
and disk search must equal device search bit for bit (ids, dists, n_comps,
n_steps), and the reference's host and disk search given its entries (ids,
n_comps, n_steps and bytes identical, dists within rtol 1e-5: float32 sums
taken in another order). The bf16 cast's bits must equal ``ml_dtypes``'
(reached through the reference, which needs it; the port does not).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import pq as jpq
from repro.core import base_store as jbs
from repro.core.engine import Searcher as JSearcher
from repro.core.engine import SearchSpec as JSpec
from repro_torch.core import base_store as pbs
from repro_torch.core import beam_search, convert
from repro_torch.core.build import BuildSpec, GraphBuilder
from repro_torch.core.engine import Searcher
from repro_torch.core.topk import INVALID
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, D, NQ = 1500, 16, 24
PQ = dict(pq_m=4, pq_k=32)
DIST_TOL = dict(rtol=1e-5, atol=1e-6)
TIERS = ["host", "disk"]
SCORERS = ["pq", "sq8"]


@pytest.fixture(scope="module")
def world():
    """A port build (exact 12-NN + GD + PQ M=4 K=32) over a seeded base, and
    the reference's Searcher over the same arrays and PQ table."""
    rng = np.random.default_rng(21)
    base = rng.standard_normal((N, D), dtype=np.float32)
    queries = rng.standard_normal((NQ, D), dtype=np.float32)
    res = GraphBuilder(BuildSpec(construct="exact", graph_k=12, compress="pq", **PQ)).build(
        torch.from_numpy(base), seed=3)
    s = Searcher.from_build(torch.from_numpy(base), res, rng_seed=3)
    jpq_index = jpq.PQIndex(codebooks=jnp.asarray(res.pq.codebooks.numpy()),
                            codes=jnp.asarray(res.pq.codes.numpy()), M=4, K=32)
    js = JSearcher(jnp.asarray(base), jnp.asarray(s.neighbors.numpy()),
                   key=jax.random.PRNGKey(2), pq=jpq_index)
    return base, queries, s, js


@pytest.fixture(scope="module")
def wide():
    """n = 300 rows of d = 1,100 (4,400 f32 bytes: rows straddle pages) in
    shards of unequal rows, and a batch of ids with padding and repeats."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((300, 1100), dtype=np.float32)
    ids = rng.integers(-1, 300, size=(6, 40)).astype(np.int32)
    ids[0, :5] = [0, 1, 2, 2, 299]
    ids[1] = -1
    return base, ids, [100, 37, 163]


def _shards(base, rows, np_dtype):
    starts = np.cumsum([0] + rows[:-1])
    return [np.ascontiguousarray(base[s:s + r].astype(np_dtype)) for s, r in zip(starts, rows)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tier", ["host", "disk_spilled", "disk_shards"])
def test_gather_rows_and_bytes_match_reference(wide, tier, dtype):
    base, ids, rows = wide
    if tier == "disk_shards":
        ref_dtype = jbs.DTYPES[dtype][0]
        ref = jbs.BaseStore.from_shards(_shards(base, rows, ref_dtype), dtype=dtype)
        port_shards = [s.view(np.uint16) if dtype == "bf16" else s
                       for s in _shards(base, rows, ref_dtype)]
        port = pbs.BaseStore.from_shards(port_shards, dtype=dtype, device="cpu")
    else:
        placement = "host" if tier == "host" else "disk"
        ref = jbs.BaseStore(jnp.asarray(base), placement, dtype=dtype)
        port = pbs.BaseStore(base, placement, dtype=dtype, device="cpu")
    assert port.row_bytes == ref.row_bytes and port.nbytes == ref.nbytes
    want_rows, want_bytes = ref.gather(jnp.asarray(ids))
    got_rows, got_bytes = port.gather(torch.from_numpy(ids))
    if dtype == "bf16":
        assert got_rows.dtype == torch.bfloat16
        got_np = got_rows.view(torch.int16).numpy().view(np.uint16)
        want_np = np.asarray(want_rows).view(np.uint16)
    else:
        got_np, want_np = got_rows.numpy(), np.asarray(want_rows)
    np.testing.assert_array_equal(got_np, want_np)
    np.testing.assert_array_equal(got_bytes.numpy(), np.asarray(want_bytes))
    assert (port.gathered_rows, port.gathered_bytes) == (ref.gathered_rows, ref.gathered_bytes)
    if tier != "host":
        assert (got_bytes.numpy() % pbs.PAGE_BYTES == 0).all()
        assert got_bytes[1] == 0 and (got_bytes[2:] > 0).all()
    port.close()
    ref.close()


def test_disk_spill_shards_and_close(world):
    base, *_ = world
    store = pbs.BaseStore(base, "disk", shard_rows=600, device="cpu")
    assert len(store.shards) == 3 and store.spill_dir and os.path.isdir(store.spill_dir)
    ids = torch.tensor([[0, 599, 600, 1499], [1200, INVALID, 42, 601]], dtype=torch.int32)
    rows, nbytes = store.gather(ids)
    want = base[np.maximum(ids.numpy(), 0)]
    np.testing.assert_array_equal(rows.numpy(), want)
    assert (nbytes > 0).all()
    spill = store.spill_dir
    store.close()
    assert not os.path.exists(spill) and store.spill_dir is None


def test_placement_validation_and_wrap(world):
    base, *_ = world
    with pytest.raises(ValueError, match="base_placement"):
        pbs.check_placement("tape")
    with pytest.raises(ValueError, match="store_dtype"):
        pbs.check_dtype("f16")
    host = pbs.BaseStore(base, "host", device="cpu")
    with pytest.raises(ValueError, match="device-resident"):
        host.device_view()
    with pytest.raises(ValueError, match="placement"):
        pbs.BaseStore.wrap(host, "device")
    assert pbs.BaseStore.wrap(host, "host") is host
    dev = pbs.BaseStore(torch.from_numpy(base), "device")
    assert dev.device_view().device.type == "cpu"
    rows, b = dev.gather(torch.tensor([[3, -1]], dtype=torch.int32))
    assert torch.equal(rows[0, 0], torch.from_numpy(base[3])) and int(b[0]) == 0


def _same(a, b, bytes_too=True):
    for f in ("ids", "dists", "n_comps") + (("bytes_touched",) if bytes_too else ()):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(a.n_steps) == int(b.n_steps)


@pytest.mark.parametrize("entry", ["random", "projection"])
@pytest.mark.parametrize("scorer", SCORERS)
def test_host_and_disk_search_equal_device_bit_for_bit(world, scorer, entry):
    _, queries, s, _ = world
    q = torch.from_numpy(queries)
    spec = s.spec(ef=32, k=4, entry=entry, scorer=scorer, **PQ)
    dev = s.search(q, spec, 5)
    host = s.search(q, spec._replace(base_placement="host"), 5)
    disk = s.search(q, spec._replace(base_placement="disk"), 5)
    _same(dev, host)                    # device and host bill the same rows
    _same(dev, disk, bytes_too=False)
    scored = host.bytes_touched - 32 * 4 * D
    pages = disk.bytes_touched - scored
    assert (pages >= pbs.PAGE_BYTES).all() and (pages % pbs.PAGE_BYTES == 0).all()


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("scorer", SCORERS)
def test_tier_search_matches_reference_given_its_entries(world, scorer, tier):
    _, queries, s, js = world
    kw = dict(ef=32, k=4, entry="random", scorer=scorer, base_placement=tier, **PQ)
    jspec = JSpec(**kw)
    jq = jnp.asarray(queries)
    ent, ec = js.seed(jq, jspec)
    want = js.search(jq, jspec, entries=ent, entry_comps=ec)
    got = s.search(torch.from_numpy(queries), s.spec(**kw),
                   entries=torch.from_numpy(np.array(ent, np.int32)),
                   entry_comps=torch.from_numpy(np.array(ec, np.int32)))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.n_comps.numpy(), np.asarray(want.n_comps))
    np.testing.assert_array_equal(got.bytes_touched.numpy(), np.asarray(want.bytes_touched))
    np.testing.assert_array_equal(got.host_bytes.numpy(), np.asarray(want.host_bytes))
    assert int(got.n_steps) == int(want.n_steps)
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), **DIST_TOL)


def test_wide_rows_disk_search_matches_reference(wide):
    """d = 1,100: every f32 row straddles a page; the disk tier bills what
    the reference bills, from shards of unequal rows."""
    base, _, rows = wide
    from repro.core import bruteforce as jbrute

    nbrs = np.asarray(jbrute.exact_knn_graph(jnp.asarray(base), 8).neighbors)
    queries = np.random.default_rng(9).standard_normal((5, 1100), dtype=np.float32)
    js = JSearcher(jnp.asarray(base), jnp.asarray(nbrs), key=jax.random.PRNGKey(1))
    js.attach_store(jbs.BaseStore.from_shards(_shards(base, rows, np.float32)))
    ps = convert.searcher_from_numpy(base, nbrs, device="cpu")
    ps.attach_store(pbs.BaseStore.from_shards(_shards(base, rows, np.float32), device="cpu"))
    kw = dict(ef=16, k=3, scorer="sq8", base_placement="disk")
    ent, ec = js.seed(jnp.asarray(queries), JSpec(**kw))
    want = js.search(jnp.asarray(queries), JSpec(**kw), entries=ent, entry_comps=ec)
    got = ps.search(torch.from_numpy(queries), ps.spec(**kw),
                    entries=torch.from_numpy(np.array(ent, np.int32)),
                    entry_comps=torch.from_numpy(np.array(ec, np.int32)))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.bytes_touched.numpy(), np.asarray(want.bytes_touched))
    np.testing.assert_array_equal(got.n_comps.numpy(), np.asarray(want.n_comps))


@pytest.mark.parametrize("tier", TIERS)
def test_stream_pipeline_matches_monolithic(world, tier):
    """search_stream under a tier (tile i's rows in flight while tile i+1
    traverses) equals its device-placed stream and each tile's direct
    search, bytes included."""
    _, queries, s, _ = world
    from repro_torch.core.engine import _fold

    q = torch.from_numpy(queries)
    spec = s.spec(ef=32, k=2, entry="projection", scorer="pq", base_placement=tier, **PQ)
    stream = s.search_stream(q, spec, 8, tile_q=10)      # 24 = 10 + 10 + 4 (padded)
    dev = s.search_stream(q, spec._replace(base_placement="device"), 8, tile_q=10)
    _same(stream, dev, bytes_too=tier == "host")
    tile = s.search(q[20:], spec, _fold(8, 2))
    assert torch.equal(stream.ids[20:], tile.ids)
    assert torch.equal(stream.bytes_touched[20:], tile.bytes_touched)
    mono = s.search(q, spec)
    assert torch.equal(stream.ids, mono.ids) and torch.equal(stream.dists, mono.dists)


def test_rerank_budget_bounds_the_traffic(world):
    _, queries, s, _ = world
    q = torch.from_numpy(queries)
    s._stores.pop(("host", "f32"), None)
    spec = s.spec(ef=48, k=1, entry="projection", scorer="pq", base_placement="host", **PQ)
    full = s.search(q, spec)
    lean = s.search(q, spec._replace(rerank=8))
    diff = full.bytes_touched - lean.bytes_touched
    assert torch.equal(diff, torch.full((NQ,), (48 - 8) * D * 4, dtype=diff.dtype))
    st = s.base_store("host")
    assert st.gathered_bytes == (48 + 8) * NQ * D * 4
    assert st.gathered_rows == (48 + 8) * NQ


def test_beam_traverse_refuses_a_scorer_that_reads_the_base(world):
    _, queries, s, _ = world
    ent = torch.zeros((NQ, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="base-free"):
        beam_search.beam_traverse(torch.from_numpy(queries), s.neighbors, ent, ef=8,
                                  scorer="exact")


def test_beam_traverse_is_beam_search_without_its_rerank(world):
    _, queries, s, _ = world
    q = torch.from_numpy(queries)
    ent = s.seed(q, s.spec(entry="projection"))[0]
    spec = s.spec(ef=32, k=4, scorer="pq", **PQ)
    state = s.scorer_state(q, spec)
    trav = beam_search.beam_traverse(q, s.neighbors, ent, ef=32, k=4, scorer="pq",
                                     scorer_state=state)
    full = beam_search.beam_search(q, s.base, s.neighbors, ent, ef=32, k=4, scorer="pq",
                                   scorer_state=state)
    assert int(trav.n_steps) == int(full.n_steps)
    dd, ids = pbs.rerank_gathered(q, trav.cand_ids, s.base[trav.cand_ids.clamp(min=0).long()],
                                  k=4)
    assert torch.equal(ids, full.ids) and torch.equal(dd, full.dists)


def test_check_tier_messages(world):
    _, queries, s, _ = world
    q = torch.from_numpy(queries)
    for placement in TIERS:
        with pytest.raises(ValueError, match="base-free scorer"):
            s.search(q, s.spec(ef=16, base_placement=placement))
    with pytest.raises(ValueError, match="unknown base_placement 'tape'"):
        s.search(q, s.spec(ef=16, scorer="pq", base_placement="tape", **PQ))
    with pytest.raises(ValueError, match="unknown store_dtype 'f16'"):
        s.search(q, s.spec(ef=16, scorer="pq", base_placement="host", store_dtype="f16", **PQ))
    with pytest.raises(ValueError, match="requires base_placement='device'"):
        s.search_with_trace(q, s.spec(ef=16, scorer="pq", base_placement="host", **PQ))


def test_bf16_cast_bits_equal_ml_dtypes():
    """The port's round-to-nearest-even cast against ml_dtypes' bfloat16
    (the reference's DTYPES["bf16"]): random values, exact halfway ties both
    ways, subnormals, signed zeros, infinities, the largest finite values
    and NaNs of both signs."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, size=20000, dtype=np.uint64).astype(np.uint32)
    special = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x3F807FFF, 0x00000001,
                        0x80000001, 0x00800000, 0x0000FFFF, 0x00000000, 0x80000000,
                        0x7F800000, 0xFF800000, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000,
                        0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF], np.uint32)
    x = np.concatenate([rng.standard_normal(20000).astype(np.float32),
                        bits.view(np.float32), special.view(np.float32)])
    with np.errstate(invalid="ignore"):      # the NaNs
        want = x.astype(jbs.DTYPES["bf16"][0]).view(np.uint16)
    np.testing.assert_array_equal(pbs.bf16_bits(x), want)
    back = pbs.bf16_to_f32(want)
    ok = ~np.isnan(back)
    np.testing.assert_array_equal(back[ok], want.view(jbs.DTYPES["bf16"][0])
                                  .astype(np.float32)[ok])


def test_bf16_store_halves_row_bytes(world):
    base, queries, s, _ = world
    assert pbs.BaseStore(base, "host", dtype="bf16", device="cpu").row_bytes * 2 == \
        pbs.BaseStore(base, "host", device="cpu").row_bytes
    q = torch.from_numpy(queries)
    spec = s.spec(ef=32, k=1, entry="projection", scorer="pq", base_placement="host", **PQ)
    f32 = s.search(q, spec)
    for tier in TIERS:
        bf = s.search(q, spec._replace(base_placement=tier, store_dtype="bf16"))
        if tier == "host":
            diff = f32.bytes_touched - bf.bytes_touched
            assert torch.equal(diff, torch.full((NQ,), 32 * D * 2, dtype=diff.dtype))
        # same traversal; the rerank at bf16 still finds what f32 finds
        assert torch.equal(bf.n_comps, f32.n_comps)
        assert float((bf.ids[:, 0] == f32.ids[:, 0]).float().mean()) >= 0.9


def test_rerank_gathered_matches_reference(world):
    base, queries, _, _ = world
    cand = np.r_[np.arange(7), [INVALID]][None].repeat(NQ, 0).astype(np.int32)
    cand[3] = cand[3][::-1]
    rows = base[np.maximum(cand, 0)]
    dd, ii = pbs.rerank_gathered(torch.from_numpy(queries), torch.from_numpy(cand),
                                 torch.from_numpy(rows), k=3)
    jd, ji = jbs.rerank_gathered(jnp.asarray(queries), jnp.asarray(cand), jnp.asarray(rows),
                                 k=3)
    np.testing.assert_array_equal(ii.numpy(), np.asarray(ji))
    np.testing.assert_allclose(dd.numpy(), np.asarray(jd), **DIST_TOL)


def test_cpu_store_has_no_copy_and_a_cuda_store_needs_a_gpu(world):
    base, *_ = world
    staged = pbs.BaseStore(base, "host", device="cpu").gather_start(
        torch.tensor([[1, 2]], dtype=torch.int32))
    assert staged.ready is None and staged.staging is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pbs.BaseStore(base, "host")      # rows go to cuda by default: no fallback
