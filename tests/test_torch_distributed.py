"""Sharded search and build: the port's shard helpers
(``repro_torch.core.engine``), ``launch.mesh.make_flat_group`` and
``repro_torch.distributed.sharded_ann`` against live calls into ``repro``,
and against themselves across four gloo ranks, on the CPU.

The world is the reference's fixture's size (n=4,000, d=16, 50 queries, P=4
shards of 1,000) from a numpy seed. The reference's draws (its NN-Descent
shard graphs, its PQ codebooks and codes, its entries) are carried across,
so the beam is deterministic on both sides: ids and comps must be
identical, dists within rtol 1e-5, atol 1e-6 (float32 sums taken in
another order), as the search tests hold them. Where the port draws its
own (NN-Descent), the shard graphs are held by the graph-recall proxy.

The four-rank runs spawn four processes (``torch.multiprocessing``, a
``FileStore``, ``OMP_NUM_THREADS=1``); the reference's four-device
``shard_map`` runs in a child with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``. Each spawn and
each collective has its own timeout, so a hang fails its test.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_shard_worker as worker
from repro.baselines import pq as jpq
from repro.core import bruteforce as jbrute
from repro.core import diversify as jdiv
from repro.core import engine as jengine
from repro.core import filters as jfilters
from repro.core import nndescent as jnd
from repro.core.build import BuildSpec as JBuildSpec
from repro.distributed import sharded_ann as jsa
from repro.launch.mesh import make_flat_mesh
from repro_torch.baselines import pq as ppq
from repro_torch.core import beam_search, convert
from repro_torch.core import engine as pengine
from repro_torch.core.build import BuildSpec
from repro_torch.core.topk import INVALID
from repro_torch.distributed import sharded_ann as psa
from repro_torch.launch.mesh import FlatGroup, make_flat_group
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
N, D, Q, P = 4000, 16, 50, 4
PER = N // P
DIST_TOL = dict(rtol=1e-5, atol=1e-6)
SPAWN_TIMEOUT_S = 100
# NN-Descent + GD per shard, as the reference's tests size it (k=16, 8 rounds)
ND_SPEC = dict(construct="nndescent", diversify="gd", graph_k=16, nd_rounds=8,
               proxy_sample=256, lid_sample=0)
EXACT_SPEC = dict(construct="exact", diversify="gd", graph_k=12, compress="pq", pq_m=8,
                  pq_k=64, pq_iters=5, proxy_sample=0, lid_sample=0)
# the port's shard graphs from its own NN-Descent draws: each shard's
# graph-recall proxy within this of the reference's (over seeds the two sat
# within 0.02 of each other on this world)
PROXY_TOL = 0.05


def _t(a, dtype=torch.float32):
    return convert.tensor(a, dtype, device="cpu")


def _same(got, want_ids, want_dists, want_comps=None):
    d, i = got[0], got[1]
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(d.numpy(), np.asarray(want_dists), **DIST_TOL)
    if want_comps is not None:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want_comps))


@pytest.fixture(scope="module")
def world():
    """The base, the queries, the reference's global NN-Descent + GD graph
    (P=1's shard) and its exact top-4."""
    rng = np.random.default_rng(0)
    base = rng.random((N, D), dtype=np.float32)
    queries = rng.random((Q, D), dtype=np.float32)
    key = jax.random.PRNGKey(0)
    g = jnd.build_knn_graph(jnp.asarray(base), jnd.NNDescentConfig(k=16, rounds=8), key=key)
    gd = jdiv.build_gd_graph(jnp.asarray(base), g)
    gt = np.asarray(jbrute.ground_truth(jnp.asarray(queries), jnp.asarray(base), 4))
    return dict(base=base, queries=queries, nbrs=np.asarray(gd.neighbors), gt=gt)


@pytest.fixture(scope="module")
def shards(world):
    """The reference's P=4 shard build (NN-Descent + GD, the graph-recall
    proxy on), its per-shard PQ (M=8, K=64) and its (P, Q, 8) entries."""
    jr = jsa.shard_build(jnp.asarray(world["base"]), P, spec=JBuildSpec(**ND_SPEC),
                         key=jax.random.PRNGKey(1))
    cbs, codes = jsa.shard_pq(jr.base_shards, M=8, K=64, key=jax.random.PRNGKey(5))
    ent = jax.random.randint(jax.random.PRNGKey(3), (P, Q, 8), 0, PER, dtype=jnp.int32)
    return dict(base_shards=np.asarray(jr.base_shards), nbr_shards=np.asarray(jr.nbr_shards),
                codebooks=np.asarray(cbs), codes=np.asarray(codes), entries=np.asarray(ent),
                proxies=[r.graph_recall_proxy for r in jr.reports])


@pytest.fixture(scope="module")
def one_rank():
    """The port's flat group on one in-process gloo rank, and the
    reference's one-device flat mesh."""
    created = not dist.is_initialized()
    fg = make_flat_group("cpu")
    yield fg, make_flat_mesh()
    if created:
        dist.destroy_process_group()


# -- globalize, merge, entries -------------------------------------------------


@pytest.mark.parametrize("shard_id", [0, 3])
def test_globalize_ids_matches_reference(shard_id):
    rng = np.random.default_rng(shard_id)
    ids = rng.integers(-1, PER, (20, 8)).astype(np.int32)
    ids[0] = INVALID
    want = np.asarray(jengine.globalize_ids(jnp.asarray(ids), shard_id, PER))
    got = pengine.globalize_ids(_t(ids, torch.int32), shard_id, PER)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 4, 10])
def test_merge_shard_results_matches_reference(k):
    """Ties (distances on a half-integer grid), INVALID ids at +inf and an
    all-dead row: the same values and the same ids, tie order included."""
    rng = np.random.default_rng(k)
    dists = (rng.integers(0, 6, (30, P * 10)) / 2).astype(np.float32)
    ids = rng.integers(0, N, (30, P * 10)).astype(np.int32)
    dead = rng.random(dists.shape) < 0.2
    dead[0] = True
    dists[dead], ids[dead] = np.inf, INVALID
    wd, wi = jengine.merge_shard_results(jnp.asarray(dists), jnp.asarray(ids), k)
    gd, gi = pengine.merge_shard_results(_t(dists), _t(ids, torch.int32), k)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_shard_entries_are_local_dup_free_and_seeded():
    def draw(seed):
        return pengine.shard_entries(torch.Generator().manual_seed(seed), P, Q, PER, 8)

    ent = draw(3)
    assert ent.shape == (P, Q, 8) and ent.dtype == torch.int32
    assert int(ent.max()) < PER and int(ent.min()) >= INVALID
    rows = ent.reshape(P * Q, 8)
    srt, _ = torch.sort(rows, dim=1)
    assert not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()
    assert torch.equal(ent, draw(3)) and not torch.equal(ent, draw(4))


# -- build --------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_shard_graph_masked_matches_reference(world, n_shards):
    """rebuild=False masks the global graph to each shard's own targets, in
    local ids (3 shards drop the last row, as the reference does)."""
    wb, wn = jsa.shard_graph(jnp.asarray(world["base"]), jnp.asarray(world["nbrs"]),
                             n_shards, rebuild=False)
    gb, gn = psa.shard_graph(_t(world["base"]), _t(world["nbrs"], torch.int32), n_shards,
                             rebuild=False)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))


@pytest.fixture(scope="module")
def exact_builds(world):
    """The exact construct + GD + pq compress per shard, both packages."""
    jr = jsa.shard_build(jnp.asarray(world["base"]), P, spec=JBuildSpec(**EXACT_SPEC),
                         key=jax.random.PRNGKey(2))
    pr = psa.shard_build(_t(world["base"]), P, spec=BuildSpec(**EXACT_SPEC), seed=2)
    return jr, pr


def test_shard_build_exact_adjacency_matches_reference(world, exact_builds):
    jr, pr = exact_builds
    np.testing.assert_array_equal(pr.base_shards.numpy(), np.asarray(jr.base_shards))
    np.testing.assert_array_equal(pr.nbr_shards.numpy(), np.asarray(jr.nbr_shards))
    assert len(pr.reports) == P and all(r.n == PER for r in pr.reports)


@pytest.mark.parametrize("metric", ["ip", "cos"])
def test_shard_build_exact_adjacency_matches_reference_other_metrics(world, metric):
    spec = dict(EXACT_SPEC, compress="none", metric=metric)
    jr = jsa.shard_build(jnp.asarray(world["base"]), 2, spec=JBuildSpec(**spec),
                         key=jax.random.PRNGKey(2))
    pr = psa.shard_build(_t(world["base"]), 2, spec=BuildSpec(**spec), seed=2)
    np.testing.assert_array_equal(pr.nbr_shards.numpy(), np.asarray(jr.nbr_shards))
    assert pr.pq_codebooks is None and pr.pq_codes is None


def test_shard_build_pq_codes_match_reference_codebooks(exact_builds):
    """Given the reference's per-shard codebooks, the port encodes each
    shard to the reference's codes; its own build encodes with its own."""
    jr, pr = exact_builds
    M, K = EXACT_SPEC["pq_m"], EXACT_SPEC["pq_k"]
    assert pr.pq_codebooks.shape == (P, M, K, D // M)
    assert pr.pq_codes.shape == (P, PER, M) and pr.pq_codes.dtype == torch.uint8
    for s in range(P):
        got = ppq._encode(pr.base_shards[s], _t(np.asarray(jr.pq_codebooks[s])))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jr.pq_codes[s]))
        assert torch.equal(ppq._encode(pr.base_shards[s], pr.pq_codebooks[s]), pr.pq_codes[s])


def test_shard_build_nndescent_proxy_near_reference(world, shards):
    pr = psa.shard_build(_t(world["base"]), P, spec=BuildSpec(**ND_SPEC), seed=1)
    got = [r.graph_recall_proxy for r in pr.reports]
    for g, w in zip(got, shards["proxies"]):
        assert abs(g - w) <= PROXY_TOL, (got, shards["proxies"])
    assert min(got) >= 0.9, got


def test_shard_build_rejects_hnsw(world):
    spec = dict(construct="hnsw", diversify="none")
    with pytest.raises(ValueError, match="construct='hnsw'"):
        jsa.shard_build(jnp.asarray(world["base"]), P, spec=JBuildSpec(**spec))
    with pytest.raises(ValueError, match="construct='hnsw'"):
        psa.shard_build(_t(world["base"]), P, spec=BuildSpec(**spec))


def test_shard_build_is_deterministic_from_spec_and_seed(world):
    """Identical from (spec, seed); another seed draws other graphs; a rank
    that builds only its own shard (build_shard) gets the stack's row."""
    base = _t(world["base"][:1200])
    spec = BuildSpec(**dict(ND_SPEC, nd_rounds=3, compress="pq", pq_m=8, pq_k=16,
                            pq_iters=2, proxy_sample=0))
    a = psa.shard_build(base, 3, spec=spec, seed=7)
    b = psa.shard_build(base, 3, spec=spec, seed=7)
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    c = psa.shard_build(base, 3, spec=spec, seed=8)
    assert not torch.equal(a.nbr_shards, c.nbr_shards)
    one = psa.build_shard(base, 3, 2, spec=spec, seed=7)
    assert torch.equal(one.graph.neighbors, a.nbr_shards[2])
    assert torch.equal(one.pq.codes, a.pq_codes[2])
    # graph_k is capped at the shard's rows less one
    tiny = psa.shard_build(base[:40], 4, spec=spec._replace(compress="none"), seed=7)
    assert tiny.reports[0].spec.graph_k == 9


def test_shard_pq_trains_each_shard_from_its_seed(shards):
    bs = _t(shards["base_shards"])
    cbs, codes = psa.shard_pq(bs, M=8, K=16, iters=3, seed=5)
    assert cbs.shape == (P, 8, 16, 2) and codes.shape == (P, PER, 8)
    again = psa.shard_pq(bs, M=8, K=16, iters=3, seed=5)
    assert torch.equal(cbs, again[0]) and torch.equal(codes, again[1])
    for s in range(P):
        one = ppq.build_pq(bs[s], M=8, K=16, iters=3, key=pengine._fold(5, s))
        assert torch.equal(one.codebooks, cbs[s]) and torch.equal(one.codes, codes[s])


def test_shards_from_numpy_carries_the_stacks(shards):
    sh = convert.shards_from_numpy(shards["base_shards"], shards["nbr_shards"],
                                   shards["codebooks"], shards["codes"], device="cpu")
    assert isinstance(sh, psa.ShardBuildResult) and sh.reports == ()
    for got, want, dtype in ((sh.base_shards, "base_shards", torch.float32),
                             (sh.nbr_shards, "nbr_shards", torch.int32),
                             (sh.pq_codebooks, "codebooks", torch.float32),
                             (sh.pq_codes, "codes", torch.uint8)):
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), shards[want])


# -- emulated search ----------------------------------------------------------


def _live(dead: int) -> np.ndarray:
    return worker.live_mask(P, dead)


def _ref_states(queries, shards, metric="l2"):
    return [(jnp.asarray(shards["codes"][s]),
             jpq.build_adc_luts(jnp.asarray(queries), jnp.asarray(shards["codebooks"][s]),
                                metric)) for s in range(P)]


def _port_states(queries, shards, metric="l2"):
    return [psa.pq_shard_state(_t(queries), _t(shards["codebooks"][s]),
                               _t(shards["codes"][s], torch.uint8), metric)
            for s in range(P)]


def _live_beam_comps(queries, shards, live, spec, states=None, denies=None):
    """The port's own per-shard beams' n_comps, summed over live shards."""
    total = np.zeros((Q,), np.int64)
    for s in range(P):
        if not live[s]:
            continue
        res = beam_search.beam_search(
            _t(queries), _t(shards["base_shards"][s]), _t(shards["nbr_shards"][s], torch.int32),
            _t(shards["entries"][s], torch.int32), ef=spec.ef, k=spec.k, scorer=spec.scorer,
            scorer_state=None if states is None else states[s],
            deny=None if denies is None else denies[s])
        total += res.n_comps.numpy()
    return total


@pytest.mark.parametrize("scorer", ["exact", "pq"])
@pytest.mark.parametrize("dead", [-1, 0, 2])
def test_emulated_shard_search_matches_reference(world, shards, scorer, dead):
    q = world["queries"]
    live = _live(dead)
    jspec = jengine.SearchSpec(ef=48, k=4, scorer=scorer)
    spec = pengine.SearchSpec(ef=48, k=4, scorer=scorer)
    wd, wi = jengine.emulated_shard_search(
        jnp.asarray(q), jnp.asarray(shards["base_shards"]), jnp.asarray(shards["nbr_shards"]),
        jnp.asarray(shards["entries"]), jnp.asarray(live), jspec,
        scorer_states=_ref_states(q, shards) if scorer == "pq" else None)
    states = _port_states(q, shards) if scorer == "pq" else None
    got = pengine.emulated_shard_search(
        _t(q), _t(shards["base_shards"]), _t(shards["nbr_shards"], torch.int32),
        _t(shards["entries"], torch.int32), torch.from_numpy(live), spec,
        scorer_states=states)
    _same(got, wi, wd, _live_beam_comps(q, shards, live, spec, states))
    if dead >= 0:
        ids = got[1].numpy()
        assert not ((ids >= dead * PER) & (ids < (dead + 1) * PER)).any()


def test_emulated_shard_search_with_per_shard_denies(world, shards):
    """Per-shard filter words over local ids, with shard 1 dead: the
    reference's ids, and no denied id answers."""
    rng = np.random.default_rng(11)
    q = world["queries"]
    denied = rng.random((P, PER)) < 0.3
    words = [jfilters.pack_bitmap(denied[s]) for s in range(P)]
    ent = np.stack([np.stack([rng.choice(np.flatnonzero(~denied[s]), 8, replace=False)
                              for _ in range(Q)]) for s in range(P)]).astype(np.int32)
    live = _live(1)
    spec = pengine.SearchSpec(ef=48, k=4)
    wd, wi = jengine.emulated_shard_search(
        jnp.asarray(q), jnp.asarray(shards["base_shards"]), jnp.asarray(shards["nbr_shards"]),
        jnp.asarray(ent), jnp.asarray(live), jengine.SearchSpec(ef=48, k=4),
        denies=[jnp.asarray(w) for w in words])
    denies = [convert.bitmap_from_uint32(w, "cpu") for w in words]
    got = pengine.emulated_shard_search(
        _t(q), _t(shards["base_shards"]), _t(shards["nbr_shards"], torch.int32),
        _t(ent, torch.int32), live, spec, denies=denies)
    _same(got, wi, wd, _live_beam_comps(q, dict(shards, entries=ent), live, spec,
                                        denies=denies))
    ids = got[1].numpy()
    shard, local = ids // PER, ids % PER
    assert not denied[shard[ids >= 0], local[ids >= 0]].any()


@pytest.mark.parametrize("placement", ["host", "disk"])
def test_shard_bodies_refuse_a_host_tier_with_the_reference_message(world, shards,
                                                                    one_rank, placement):
    q = world["queries"]
    jspec = jengine.SearchSpec(ef=48, k=4, scorer="pq", base_placement=placement)
    spec = pengine.SearchSpec(ef=48, k=4, scorer="pq", base_placement=placement)
    with pytest.raises(ValueError, match="emulated_shard_search reranks in-shard"):
        jengine.emulated_shard_search(jnp.asarray(q), jnp.asarray(shards["base_shards"]),
                                      jnp.asarray(shards["nbr_shards"]),
                                      jnp.asarray(shards["entries"]), jnp.ones((P,), bool),
                                      jspec)
    with pytest.raises(ValueError, match="emulated_shard_search reranks in-shard"):
        pengine.emulated_shard_search(_t(q), _t(shards["base_shards"]),
                                      _t(shards["nbr_shards"], torch.int32),
                                      _t(shards["entries"], torch.int32), np.ones(P, bool),
                                      spec)
    with pytest.raises(ValueError, match="shard_search reranks in-shard"):
        pengine.shard_search(_t(q), _t(shards["base_shards"][0]),
                             _t(shards["nbr_shards"][0], torch.int32),
                             _t(shards["entries"][0], torch.int32), True, spec=spec,
                             group=one_rank[0].group, per=PER)


# -- one rank against the reference's one-device mesh ---------------------------


def test_make_flat_group_on_the_cpu_is_one_gloo_rank(one_rank):
    fg, mesh = one_rank
    assert isinstance(fg, FlatGroup) and (fg.rank, fg.size) == (0, 1)
    assert dist.get_backend(fg.group) == "gloo"
    assert mesh.devices.size == 1
    assert make_flat_group("cpu") == fg   # the set-up group is returned as it is


@pytest.fixture(scope="module")
def one_shard(world):
    """P=1: the global graph as the one shard, the reference's entries and
    its PQ on it."""
    bs, ns = world["base"][None], world["nbrs"][None]
    cbs, codes = jsa.shard_pq(jnp.asarray(bs), M=8, K=64, key=jax.random.PRNGKey(5))
    ent = jax.random.randint(jax.random.PRNGKey(3), (1, Q, 8), 0, N, dtype=jnp.int32)
    return dict(base_shards=bs, nbr_shards=ns, codebooks=np.asarray(cbs),
                codes=np.asarray(codes), entries=np.asarray(ent))


ONE_RANK_CASES = {"exact": ("exact", "device", True), "exact_dead": ("exact", "device", False),
                  "pq": ("pq", "device", True), "pq_host": ("pq", "host", True),
                  "pq_disk": ("pq", "disk", True)}


@pytest.mark.parametrize("case", list(ONE_RANK_CASES))
def test_distributed_search_one_rank_matches_reference(world, one_shard, one_rank, case):
    scorer, placement, alive = ONE_RANK_CASES[case]
    fg, mesh = one_rank
    sh = one_shard
    q = world["queries"]
    live = np.array([alive])
    jkw = dict(ef=48, k=4, mesh=mesh, axis=mesh.axis_names[0], scorer=scorer)
    pkw = dict(ef=48, k=4, group=fg.group, scorer=scorer)
    if scorer == "pq":
        jkw.update(pq_codebooks=jnp.asarray(sh["codebooks"]), pq_codes=jnp.asarray(sh["codes"]))
        pkw.update(pq_codebooks=_t(sh["codebooks"]), pq_codes=_t(sh["codes"], torch.uint8))
    if placement != "device":
        jkw.update(base_placement=placement, host_base=world["base"])
        pkw.update(base_placement=placement, host_base=world["base"])
    device = placement == "device"
    want = jsa.distributed_search(
        jnp.asarray(q), jnp.asarray(sh["base_shards"]) if device else None,
        jnp.asarray(sh["nbr_shards"]), jnp.asarray(sh["entries"]), jnp.asarray(live), **jkw)
    got = psa.distributed_search(
        _t(q), _t(sh["base_shards"]) if device else None, _t(sh["nbr_shards"], torch.int32),
        _t(sh["entries"], torch.int32), torch.from_numpy(live), **pkw)
    _same(got, want[1], want[0], want[2])
    if alive:
        r1 = float((got[1][:, 0].numpy() == world["gt"][:, 0]).mean())
        assert r1 > 0.9, r1
    else:
        assert (got[1] == INVALID).all() and (got[2] == 0).all()


def test_distributed_search_errors_match_reference(world, one_shard, one_rank):
    fg, mesh = one_rank
    sh = one_shard
    q = world["queries"]
    jargs = (jnp.asarray(q), jnp.asarray(sh["base_shards"]), jnp.asarray(sh["nbr_shards"]),
             jnp.asarray(sh["entries"]), jnp.ones((1,), bool))
    pargs = (_t(q), _t(sh["base_shards"]), _t(sh["nbr_shards"], torch.int32),
             _t(sh["entries"], torch.int32), torch.ones(1, dtype=torch.bool))
    jkw = dict(ef=48, k=4, mesh=mesh, axis=mesh.axis_names[0])
    pkw = dict(ef=48, k=4, group=fg.group)
    jpqkw = dict(pq_codebooks=jnp.asarray(sh["codebooks"]), pq_codes=jnp.asarray(sh["codes"]))
    ppqkw = dict(pq_codebooks=_t(sh["codebooks"]), pq_codes=_t(sh["codes"], torch.uint8))
    cases = [(dict(scorer="pq"), {}, {}, "pq_codebooks/pq_codes"),
             (dict(scorer="pq", base_placement="host", host_base=world["base"]), {}, {},
              "traverses per-shard code tables"),
             (dict(scorer="pq", base_placement="disk"), jpqkw, ppqkw, "needs host_base="),
             (dict(scorer="pq", base_placement="tape", host_base=world["base"]), jpqkw, ppqkw,
              "tape")]
    for kw, jextra, pextra, match in cases:
        with pytest.raises(ValueError, match=match):
            jsa.distributed_search(*jargs, **jkw, **kw, **jextra)
        with pytest.raises(ValueError, match=match):
            psa.distributed_search(*pargs, **pkw, **kw, **pextra)
    with pytest.raises(ValueError, match="own shard"):
        psa.distributed_search(pargs[0], pargs[1].expand(2, -1, -1), *pargs[2:], **pkw)


def test_distributed_build_and_search_on_one_rank(world, one_rank):
    """One rank, one shard built from (seed) over the whole base, all live:
    graph-grade recall, as the reference's wrapper."""
    fg, _ = one_rank
    d, i, comps = psa.distributed_build_and_search(_t(world["base"]), _t(world["queries"]),
                                                   fg.group, ef=48, k=1, seed=0)
    r1 = float((i[:, 0].numpy() == world["gt"][:, 0]).mean())
    assert r1 > 0.9, r1
    assert d.shape == (Q, 1) and (comps > 0).all()


# -- four ranks ------------------------------------------------------------------


@pytest.fixture(scope="module")
def four_rank_inputs(world, shards, tmp_path_factory):
    inputs = {"queries": world["queries"], "base": world["base"],
              "base_shards": shards["base_shards"], "nbr_shards": shards["nbr_shards"],
              "entries": shards["entries"], "codebooks": shards["codebooks"],
              "codes": shards["codes"]}
    path = tmp_path_factory.mktemp("shard_inputs") / "inputs.npz"
    np.savez(path, **inputs)
    return inputs, path


@pytest.fixture(scope="module")
def four_ranks(four_rank_inputs, tmp_path_factory):
    """``distributed_search`` on four spawned gloo ranks, every case of
    ``torch_shard_worker.CASES``; each rank's results."""
    inputs, _ = four_rank_inputs
    out = tmp_path_factory.mktemp("four_ranks")
    ctx = mp.get_context("spawn")
    before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [ctx.Process(target=worker.run_rank,
                             args=(r, P, str(out / "store"), inputs, str(out)))
                 for r in range(P)]
        for p in procs:
            p.start()
    finally:
        if before is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = before
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join(10)
    assert not hung, f"ranks {hung} still running after {SPAWN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * P
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(P)]


def _case(name):
    return next(c for c in worker.CASES if c[0] == name)


def test_four_ranks_answer_the_same_on_every_rank(four_ranks):
    for r in range(1, P):
        assert four_ranks[r].keys() == four_ranks[0].keys()
        for key, val in four_ranks[r].items():
            np.testing.assert_array_equal(val, four_ranks[0][key], err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("name", [c[0] for c in worker.CASES if c[2] == "device"])
def test_four_ranks_are_bit_identical_to_emulated(world, shards, four_ranks, name):
    _, scorer, _, dead = _case(name)
    q = world["queries"]
    live = _live(dead)
    spec = pengine.SearchSpec(ef=worker.SEARCH["ef"], k=worker.SEARCH["k"], scorer=scorer)
    states = _port_states(q, shards) if scorer == "pq" else None
    md, mi, mc = pengine.emulated_shard_search(
        _t(q), _t(shards["base_shards"]), _t(shards["nbr_shards"], torch.int32),
        _t(shards["entries"], torch.int32), live, spec, scorer_states=states)
    got = four_ranks[0]
    np.testing.assert_array_equal(got[f"{name}_ids"], mi.numpy())
    np.testing.assert_array_equal(got[f"{name}_dists"], md.numpy())
    np.testing.assert_array_equal(got[f"{name}_comps"], mc.numpy())
    np.testing.assert_array_equal(got[f"{name}_comps"],
                                  _live_beam_comps(q, shards, live, spec, states))


@pytest.mark.parametrize("name", [c[0] for c in worker.CASES if c[2] == "host"])
def test_four_ranks_host_tier_matches_device_pq(four_ranks, name):
    """The reference's claim for the host tier: the device pq run's ids
    (with the same shard dead), dists within tolerance, comps within P (the
    device path scales M/d per shard before the sum, the host path after
    it)."""
    got = four_ranks[0]
    dev = name.replace("_host", "")
    np.testing.assert_array_equal(got[f"{name}_ids"], got[f"{dev}_ids"])
    np.testing.assert_allclose(got[f"{name}_dists"], got[f"{dev}_dists"], **DIST_TOL)
    assert np.abs(got[f"{name}_comps"].astype(np.int64) - got[f"{dev}_comps"]).max() <= P


REF_FOUR_DEVICES = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
sys.path[:0] = [sys.argv[3], sys.argv[4]]
import torch_shard_worker as worker
from repro.distributed.sharded_ann import distributed_search
from repro.launch.mesh import make_flat_mesh

mesh = make_flat_mesh()
P = mesh.devices.size
if P != 4:
    print(json.dumps({"devices": P}))
    sys.exit(0)
x = dict(np.load(sys.argv[1]))
out = {}
for name, scorer, placement, dead in worker.CASES:
    kw = dict(worker.SEARCH, mesh=mesh, axis=mesh.axis_names[0], scorer=scorer)
    if scorer == "pq":
        kw.update(pq_codebooks=jnp.asarray(x["codebooks"]), pq_codes=jnp.asarray(x["codes"]))
    if placement != "device":
        kw.update(base_placement=placement, host_base=x["base"])
    d, i, c = distributed_search(
        jnp.asarray(x["queries"]),
        jnp.asarray(x["base_shards"]) if placement == "device" else None,
        jnp.asarray(x["nbr_shards"]), jnp.asarray(x["entries"]),
        jnp.asarray(worker.live_mask(P, dead)), **kw)
    out[name + "_dists"], out[name + "_ids"], out[name + "_comps"] = map(np.asarray, (d, i, c))
np.savez(sys.argv[2], **out)
print(json.dumps({"devices": P}))
"""


@pytest.fixture(scope="module")
def reference_four_devices(four_rank_inputs, tmp_path_factory):
    """The reference's ``distributed_search`` on a real four-device
    ``shard_map`` (four host-platform devices), in a child process."""
    _, path = four_rank_inputs
    out = tmp_path_factory.mktemp("ref_four") / "out.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", REF_FOUR_DEVICES, str(path), str(out),
                           str(ROOT / "src"), str(ROOT / "tests")],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    devices = json.loads(proc.stdout.strip().splitlines()[-1])["devices"]
    if devices != 4:
        pytest.skip(f"the reference's child saw {devices} host devices, not 4")
    return dict(np.load(out))


@pytest.mark.parametrize("name", [c[0] for c in worker.CASES])
def test_four_ranks_match_the_reference_four_device_shard_map(four_ranks,
                                                             reference_four_devices, name):
    got, want = four_ranks[0], reference_four_devices
    np.testing.assert_array_equal(got[f"{name}_ids"], want[f"{name}_ids"])
    np.testing.assert_array_equal(got[f"{name}_comps"], want[f"{name}_comps"])
    np.testing.assert_allclose(got[f"{name}_dists"], want[f"{name}_dists"], **DIST_TOL)


# -- the example ----------------------------------------------------------------


def test_example_runs_on_the_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "distributed_ann_torch.py"),
                           "--device", "cpu", "--n", "4000"],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if "recall@1=" in ln]
    assert [ln.split(":")[0] for ln in lines] == ["shards=4 dead=0", "shards=4 dead=1"]
    full, degraded = (float(ln.split("recall@1=")[1].split(",")[0]) for ln in lines)
    assert full > 0.9 and degraded < full
