"""The port's continuous-batching server (``repro_torch.launch.server``)
on the CPU, on the reference tests' small world (1,500 x 16 uniform from
PRNGKey(9), 32 queries; ``tests/test_server.py``).

The contract is the reference's: a request padded up to its bucket and
searched under the ``q_valid`` mask returns bit-identical ids, dists and
n_comps for its real rows against ``Searcher.search`` of those rows with
the request's seed, across every entry strategy, the exact / pq / sq8
scorers, the device and host placements, and under ``term="stable"`` with
restarts. The serving mechanics around it (buckets, shedding, timestamps,
stats, the hot swap) follow the reference's tests. Against the reference:
its ``AnnServer`` and the port's serve the same request stream over one
graph, the port fed the reference's entries for each request
(and, under pq, its codebooks): ids and n_comps identical, dists within
1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.launch import server as jserver
from repro_torch.core import convert
from repro_torch.core.build import BuildSpec, build_index
from repro_torch.core.engine import ENTRY_STRATEGIES, Searcher, _fold
from repro_torch.core.filters import FilterSpec
from repro_torch.core.topk import INVALID
from repro_torch.launch import serve
from repro_torch.launch.server import AnnServer, Request, ServeConfig, prepared_state
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

Q_REAL = 11     # deliberately not a bucket size
BUCKET = 16
SEED = 9
DIST_TOL = dict(rtol=1e-6, atol=0)
SCORER_PLACEMENTS = [("exact", "device"), ("pq", "device"), ("pq", "host"),
                     ("sq8", "device")]


def _uniform(key, shape) -> np.ndarray:
    return np.array(jax.random.uniform(key, shape), np.float32)


@pytest.fixture(scope="module")
def points():
    key = jax.random.PRNGKey(SEED)
    return (_uniform(key, (1500, 16)), _uniform(jax.random.fold_in(key, 1), (32, 16)), key)


@pytest.fixture(scope="module")
def world(points):
    """The port's HNSW build of the base (a flat bottom layer plus the
    hierarchy the ``hierarchy`` seeder descends)."""
    base, queries, _ = points
    b = torch.from_numpy(base)
    res = build_index(b, BuildSpec(construct="hnsw", diversify="none"), seed=SEED)
    return Searcher.from_build(b, res, rng_seed=SEED), queries


def _assert_same(req_or_res, direct, qn=None):
    if isinstance(req_or_res, Request):
        ids, dists, comps = req_or_res.ids, req_or_res.dists, req_or_res.n_comps
    else:
        ids = req_or_res.ids[:qn].numpy()
        dists = req_or_res.dists[:qn].numpy()
        comps = req_or_res.n_comps[:qn].numpy()
    np.testing.assert_array_equal(ids, direct.ids.numpy())
    np.testing.assert_array_equal(dists, direct.dists.numpy())
    np.testing.assert_array_equal(comps, direct.n_comps.numpy())


def _server(searcher, spec, buckets=(1, 2, 4, 8), live=2, depth=8):
    return AnnServer(searcher, spec, ServeConfig(buckets=buckets, max_live_batches=live,
                                                 max_queue_depth=depth))


@pytest.mark.parametrize("entry", sorted(ENTRY_STRATEGIES))
@pytest.mark.parametrize("scorer,placement", SCORER_PLACEMENTS,
                         ids=[f"{s}-{p}" for s, p in SCORER_PLACEMENTS])
def test_padding_parity(world, entry, scorer, placement):
    """The server's padding recipe (``_search_padded``) against a direct
    search of the real rows with the same seed; pad rows do no work."""
    searcher, queries = world
    spec = searcher.spec(ef=32, k=4, entry=entry, scorer=scorer, base_placement=placement)
    srv = _server(searcher, spec, buckets=(BUCKET,))
    rows = queries[:Q_REAL]
    direct = searcher.search(torch.from_numpy(rows), spec, 123)
    padded = srv._search_padded(rows, 123, BUCKET)
    _assert_same(padded, direct, Q_REAL)
    assert (padded.n_comps[Q_REAL:] == 0).all()
    assert (padded.ids[Q_REAL:] == INVALID).all()


@pytest.mark.parametrize("entry", ["hubs", "hierarchy"])
def test_padding_parity_adaptive_termination(world, entry):
    """term="stable" and restarts survive bucketing: frozen rows reuse the
    pad-row masking, restart keys are a function of the row index."""
    searcher, queries = world
    spec = searcher.spec(ef=32, k=4, entry=entry, term="stable", stable_steps=4, restarts=1)
    srv = _server(searcher, spec, buckets=(BUCKET,))
    rows = queries[:Q_REAL]
    direct = searcher.search(torch.from_numpy(rows), spec, 321)
    padded = srv._search_padded(rows, 321, BUCKET)
    _assert_same(padded, direct, Q_REAL)
    assert (padded.n_comps[Q_REAL:] == 0).all()
    assert (padded.ids[Q_REAL:] == INVALID).all()


def test_all_true_mask_is_identity(world):
    searcher, queries = world
    spec = searcher.spec(ef=32, k=4, entry="projection")
    q = torch.from_numpy(queries[:8])
    ent, ecomps = searcher.seed(q, spec)
    a = searcher.search(q, spec, entries=ent, entry_comps=ecomps)
    b = searcher.search(q, spec, entries=ent, entry_comps=ecomps,
                        q_valid=torch.ones(8, dtype=torch.bool))
    _assert_same(b, a, 8)


def _stream(queries, n, sizes, rng_seed, seed0):
    rng = np.random.default_rng(rng_seed)
    reqs = []
    for i in range(n):
        sz = int(rng.choice(sizes))
        start = int(rng.integers(0, queries.shape[0] - sz + 1))
        reqs.append((queries[start:start + sz], seed0 + i))
    return reqs


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "stable-restarts"])
def test_server_closed_loop_bit_matches_direct(world, adaptive):
    """Through ``submit_wait``/``drain``: every request equals its direct
    search, nothing shed."""
    searcher, queries = world
    kw = dict(term="stable", stable_steps=4, restarts=1) if adaptive else {}
    spec = searcher.spec(ef=32, k=4 if not adaptive else 2, entry="random", **kw)
    server = _server(searcher, spec)
    server.warmup()
    reqs = _stream(queries, 24, (1, 2, 3, 4, 5, 7, 8), 0, 500)
    for rows, seed in reqs:
        server.submit_wait(rows, seed)
    server.drain()
    assert len(server.completed) == len(reqs) and not server.shed
    for req in sorted(server.completed, key=lambda r: r.rid):
        rows, seed = reqs[req.rid]
        _assert_same(req, searcher.search(torch.from_numpy(rows), spec, seed))


def test_default_request_seed_and_filters(world):
    """A request without a seed gets ``_fold(rng_seed, 1_000_003 + rid)``;
    a per-request filter is answered as a direct filtered search."""
    searcher, queries = world
    spec = searcher.spec(ef=32, k=4, entry="random")
    server = _server(searcher, spec)
    f = FilterSpec(deny_ids=tuple(range(0, 1500, 3)))
    a = server.submit_wait(queries[:3])
    b = server.submit_wait(queries[3:8], filter=f)
    server.drain()
    assert a.seed == _fold(searcher.rng_seed, 1_000_003) and b.seed == _fold(
        searcher.rng_seed, 1_000_004)
    _assert_same(a, searcher.search(torch.from_numpy(queries[:3]), spec, a.seed))
    _assert_same(b, searcher.search(torch.from_numpy(queries[3:8]),
                                    spec._replace(filter=f), b.seed))
    assert not np.isin(b.ids, np.arange(0, 1500, 3)).any()


def test_pick_bucket():
    srv = AnnServer.__new__(AnnServer)   # bucket logic needs no engine
    srv.config = ServeConfig(buckets=(1, 2, 4, 8))
    assert srv.pick_bucket(1) == 1
    assert srv.pick_bucket(3) == 4
    assert srv.pick_bucket(8) == 8
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        srv.pick_bucket(9)
    with pytest.raises(ValueError, match=">= 1 query row"):
        srv.pick_bucket(0)


def test_config_validation(world):
    searcher, _ = world
    spec = searcher.spec(ef=16, k=1, entry="random")
    with pytest.raises(ValueError, match="sorted unique positive"):
        AnnServer(searcher, spec, ServeConfig(buckets=(4, 2)))
    with pytest.raises(ValueError, match="sorted unique positive"):
        AnnServer(searcher, spec, ServeConfig(buckets=()))
    with pytest.raises(ValueError, match="max_live_batches"):
        AnnServer(searcher, spec, ServeConfig(max_live_batches=0))
    with pytest.raises(ValueError, match="max_live_batches"):
        AnnServer(searcher, spec, ServeConfig(max_queue_depth=0))
    assert ServeConfig() == ServeConfig(buckets=(1, 2, 4, 8, 16, 32), max_live_batches=4,
                                        max_queue_depth=64)


def test_queue_depth_shedding(world):
    """A backlogged listener enqueues without advancing: the queue holds its
    depth, everything past it is shed (recorded, never dispatched)."""
    searcher, queries = world
    spec = searcher.spec(ef=16, k=1, entry="random")
    server = _server(searcher, spec, buckets=(1, 2), live=1, depth=2)
    server.warmup()
    for i in range(6):
        server.submit(queries[i:i + 1], advance=False)
    assert len(server.queue) == 2
    assert len(server.shed) == 4
    assert all(r.shed and r.ids is None for r in server.shed)
    server.drain()
    assert len(server.completed) == 2
    st = server.stats()
    assert st["completed"] == 2 and st["shed"] == 4


def test_timestamps_and_stats(world):
    searcher, queries = world
    spec = searcher.spec(ef=16, k=1, entry="random")
    server = _server(searcher, spec, buckets=(1, 2, 4))
    server.warmup()
    for i in range(10):
        server.submit_wait(queries[i:i + 1 + (i % 3)])
    server.drain()
    for req in server.completed:
        assert req.t_enqueue <= req.t_admit <= req.t_dispatch <= req.t_complete
        assert req.latency_s >= 0 and req.queue_wait_s >= 0
        assert req.bytes_touched.shape == (req.queries.shape[0],)
    st = server.stats()
    assert st["completed"] == 10
    assert st["p50_ms"] <= st["p90_ms"] <= st["p99_ms"]
    assert st["real_rows"] == sum(1 + (i % 3) for i in range(10))
    assert st["padded_rows"] == sum(1 for i in range(10) if i % 3 == 2)
    assert 0 < st["mean_fill"] <= 1
    assert sum(st["bucket_counts"].values()) == 10
    assert 1 <= st["max_live"] <= 2


def test_oversize_request_rejected(world):
    searcher, queries = world
    spec = searcher.spec(ef=16, k=1, entry="random")
    server = AnnServer(searcher, spec, ServeConfig(buckets=(1, 2, 4)))
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        server.submit(queries[:5])
    with pytest.raises(ValueError, match=r"rows must be \(q, d\)"):
        server.submit(queries[0])


@pytest.fixture(scope="module")
def incoming():
    """A second index of another size (new search shapes)."""
    base2 = _uniform(jax.random.PRNGKey(31), (900, 16))
    return Searcher.build(torch.from_numpy(base2), seed=31, graph_k=12)


def test_hot_swap_zero_drop_and_bit_identity(world, incoming):
    """Requests served before the flip keep the old index, requests queued
    at the flip are answered by the new one, nothing is shed, each side
    equals a direct search on the version that served it, and nothing is
    built or loaded after the flip."""
    s0, queries = world
    s1 = incoming
    spec = s0.spec(ef=32, k=4, entry="random")
    server = _server(s0, spec, depth=16)
    server.warmup()
    assert server.version == 0 and server.swap_events == []
    reqs_a = _stream(queries, 6, (1, 3, 4, 8), 13, 600)
    for rows, seed in reqs_a:
        server.submit_wait(rows, seed)
    server.drain()

    reqs_b = _stream(queries, 5, (1, 3, 4, 8), 14, 700)
    for rows, seed in reqs_b:
        server.submit(rows, seed, advance=False)
    version = server.swap(s1, seed=_fold(31, 1))
    assert version == 1 and server.version == 1
    ev = server.swap_events[-1]
    assert ev["queued_at_flip"] == len(reqs_b) and ev["n"] == 900
    assert ev["live_at_flip"] == 0 and ev["warm_s"] >= 0
    at_flip = prepared_state(s1)
    server.drain()
    assert prepared_state(s1) == at_flip
    assert not server.shed
    assert len(server.completed) == len(reqs_a) + len(reqs_b)

    done = sorted(server.completed, key=lambda r: r.rid)
    for req, (rows, seed) in zip(done[:len(reqs_a)], reqs_a):
        _assert_same(req, s0.search(torch.from_numpy(rows), spec, seed))
    for req, (rows, seed) in zip(done[len(reqs_a):], reqs_b):
        _assert_same(req, s1.search(torch.from_numpy(rows), spec, seed))
        assert req.ids.max() < 900
    assert server.stats()["swaps"] == 1


@pytest.mark.parametrize("scorer", ["pq", "sq8"])
def test_swap_warms_before_flip_not_after(world, scorer):
    """Every request shape and the incoming index's per-index state (its
    scorer table, the warm filter) exist before the flip: the requests
    after it build nothing."""
    s0, queries = world
    s1 = Searcher.build(torch.from_numpy(_uniform(jax.random.PRNGKey(41), (700, 16))),
                        seed=41, graph_k=12)
    s1.metadata = {"tenant": np.arange(700) % 4}
    spec = s0.spec(ef=16, k=2, entry="random", scorer=scorer)
    server = _server(s0, spec, buckets=(1, 2, 4))
    server.warmup()
    before = prepared_state(s1)
    server.swap(s1, seed=_fold(41, 2))
    at_flip = prepared_state(s1)
    assert at_flip != before and at_flip["filter_compiles"] == 1
    assert at_flip["pq" if scorer == "pq" else "sq8"]
    for i in range(1, 5):   # every qn the bucket set admits
        server.submit_wait(queries[:i], _fold(41, 80 + i))
    server.drain()
    assert prepared_state(s1) == at_flip
    assert len(server.completed) == 4 and not server.shed


# -- against the reference ------------------------------------------------------


@pytest.fixture(scope="module")
def ref_world(points, world):
    """The reference's Searcher over the port's graph (the HNSW build's
    bottom layer) and a port Searcher over the same arrays."""
    base, queries, key = points
    nbrs = world[0].neighbors.numpy()
    ref = jengine.Searcher(jnp.asarray(base), jnp.asarray(nbrs), key=key)
    port = convert.searcher_from_numpy(base, nbrs, device="cpu")
    return ref, port, queries


@pytest.mark.parametrize("scorer", ["exact", "pq"])
def test_port_server_matches_reference_server(ref_world, scorer, monkeypatch):
    """Both servers take one request stream (sizes 1-8 from the pool); the
    port's Searcher is fed the reference's entries for each request and,
    under pq, the reference's codebooks and codes."""
    ref, port, queries = ref_world
    jspec = jengine.SearchSpec(ef=32, k=4, entry="random", scorer=scorer)
    spec = port.spec(ef=32, k=4, entry="random", scorer=scorer)
    if scorer == "pq":
        pq = ref.pq_index(jspec)
        port = convert.searcher_from_numpy(
            np.asarray(ref.base), np.asarray(ref.neighbors), device="cpu",
            pq=convert.pq_index_from_numpy(np.asarray(pq.codebooks), np.asarray(pq.codes),
                                           device="cpu"))
    reqs = _stream(queries, 12, (1, 2, 3, 5, 8), 3, 0)
    keys = [jax.random.fold_in(ref.key, 900 + i) for i in range(len(reqs))]
    entries = {}
    for (rows, seed), k in zip(reqs, keys):
        e, c = ref.seed(jnp.asarray(rows), jspec, k)
        entries[seed] = (torch.from_numpy(np.array(e)), torch.from_numpy(np.array(c)))
    own_seed = port.seed
    monkeypatch.setattr(port, "seed", lambda q, sp, seed=None: (
        entries[seed] if seed in entries else own_seed(q, sp, seed)))

    jsrv = jserver.AnnServer(ref, jspec, jserver.ServeConfig(
        buckets=(1, 2, 4, 8), max_live_batches=2, max_queue_depth=8))
    srv = _server(port, spec)
    for (rows, seed), k in zip(reqs, keys):
        jsrv.submit_wait(rows, k)
        srv.submit_wait(rows, seed)
    jsrv.drain()
    srv.drain()
    assert len(srv.completed) == len(jsrv.completed) == len(reqs)
    for got, want in zip(sorted(srv.completed, key=lambda r: r.rid),
                         sorted(jsrv.completed, key=lambda r: r.rid)):
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.n_comps, want.n_comps)
        np.testing.assert_allclose(got.dists, want.dists, **DIST_TOL)
    st, jst = srv.stats(), jsrv.stats()
    for k in ("completed", "shed", "bucket_counts", "real_rows", "padded_rows", "mean_fill"):
        assert st[k] == jst[k], k


# -- the entry point -------------------------------------------------------------


def test_serve_cli_open_loop_and_mutate(monkeypatch, capsys):
    """``serve --arch ann --smoke --serve --serve-mutate 50`` on a cut smoke
    world: the reference's report lines, completed + shed = requests on
    both streams, 0 tombstoned ids in answers, the stats under "serve"."""
    monkeypatch.setattr(serve, "SMOKE_WORLD", (2000, 16))
    run = serve.main(["--arch", "ann", "--smoke", "--device", "cpu", "--serve",
                      "--serve-requests", "40", "--serve-mutate", "50",
                      "--build-rounds", "6"])
    out = capsys.readouterr().out
    for line in ("[serve-ann] open loop: offered 500 qps over 40 requests",
                 "[serve-ann] served ", "[serve-ann] served recall@1=",
                 "largest live window", "[serve-ann] hot-swap v1: +50 inserts",
                 "tombstoned ids in answers: 0 (must be 0)"):
        assert line in out, line
    st = run.summary["serve"]
    assert st["completed"] + st["shed"] == 40
    assert st["mutate"]["completed"] + st["mutate"]["shed"] == 40
    assert st["mutate"]["dead_hits"] == 0 and st["mutate"]["swap"]["version"] == 1
    # each stream's requests against a direct search on the version that
    # served them (rids count shed submits too)
    offset = 0
    for reqs, s in run.served.streams:
        for req in run.served.server.completed:
            if 0 <= req.rid - offset < len(reqs):
                r = reqs[req.rid - offset]
                _assert_same(req, s.search(torch.from_numpy(r.rows), run.spec, r.seed))
        offset += len(reqs)
    assert run.served.mutable.n_dead == 25


def test_serve_cli_refusals():
    with pytest.raises(SystemExit, match="--serve is an --arch ann mode"):
        serve.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--serve"])
    with pytest.raises(SystemExit, match="drop --stream-tile"):
        serve.main(["--arch", "ann", "--smoke", "--device", "cpu", "--serve",
                    "--stream-tile", "16"])
