"""Index artifacts: the port's ``core.io`` against live calls into
``repro.core.io`` on the same files, on the CPU.

The port writes and the reference reads, the reference writes and the port
reads: every array must come across bit for bit (base, adjacency, hubs,
hierarchy, PQ and OPQ tables, metadata, f32 and bf16 shards, the key). A
reloaded port searcher answers exactly as before the save; given the
reference's entries it answers as the reference's reloaded searcher does
(ids, n_comps and n_steps identical, dists within rtol 1e-5: float32 sums
taken in another order).
"""
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import pq as jpq
from repro.core import graph_index as jgi
from repro.core import io as rio
from repro.core.engine import SearchSpec as JSpec
from repro_torch.core import io as pio
from repro_torch.core.build import BuildSpec, GraphBuilder
from repro_torch.core.engine import Searcher
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, D, NQ = 1500, 16, 24
SEED = 7
DIST_TOL = dict(rtol=1e-5, atol=1e-6)
PQ = dict(pq_m=4, pq_k=32)

# world -> port BuildSpec kwargs
BUILDS = {
    "flat": dict(construct="exact", diversify="none", graph_k=12),
    "gd_pq": dict(construct="exact", diversify="gd", graph_k=12, compress="pq", **PQ),
    "opq": dict(construct="exact", diversify="gd", graph_k=12, compress="opq", **PQ),
    "hier": dict(construct="hnsw", diversify="none", graph_k=12),
}
# case -> (world, search spec kwargs)
SEARCHES = {
    "flat_exact": ("flat", dict(ef=32, k=5, entry="random")),
    "pq_projection": ("gd_pq", dict(ef=32, k=5, entry="projection", scorer="pq", **PQ)),
    "pq_host": ("gd_pq", dict(ef=32, k=5, entry="random", scorer="pq",
                              base_placement="host", **PQ)),
    "opq": ("opq", dict(ef=32, k=5, entry="random", scorer="pq", **PQ)),
    "sq8_disk": ("gd_pq", dict(ef=32, k=5, entry="hubs", scorer="sq8",
                               base_placement="disk")),
    "hierarchy": ("hier", dict(ef=32, k=5, entry="hierarchy")),
    "hubs_stable_restarts": ("gd_pq", dict(ef=32, k=5, entry="hubs", term="stable",
                                           stable_steps=6, restarts=1)),
}


def _metadata(n, seed=SEED):
    rng = np.random.default_rng(seed + 100)
    return {"tenant": rng.integers(0, 4, n).astype(np.int32),
            "tag": rng.integers(0, 8, n).astype(np.int32),
            "timestamp": rng.permutation(n).astype(np.int64)}


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(SEED)
    base = rng.standard_normal((N, D), dtype=np.float32)
    queries = rng.standard_normal((NQ, D), dtype=np.float32)
    searchers = {}
    for name, kw in BUILDS.items():
        res = GraphBuilder(BuildSpec(**kw)).build(torch.from_numpy(base), seed=SEED)
        s = Searcher.from_build(torch.from_numpy(base), res, rng_seed=SEED)
        s.metadata = _metadata(N)
        searchers[name] = (s, res)
    return base, queries, searchers


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(a))
    return np.asarray(a)


def _arrays(art) -> dict:
    """Every array of an artifact (either package's), by the file's member
    names."""
    out = {"base": _np(art.base), "neighbors": _np(art.neighbors)}
    if art.hubs is not None:
        out["hubs"] = _np(art.hubs)
    if art.key is not None:
        out["key"] = _np(art.key)
    h = art.hierarchy
    if h is not None:
        out["hier_entry"] = _np(h.entry_point).reshape(())
        out["hier_levels"] = _np(h.levels)
        for i in range(h.num_layers):
            out[f"hier{i}_neighbors"] = _np(h.layers_neighbors[i])
            out[f"hier{i}_nodes"] = _np(h.layers_nodes[i])
            out[f"hier{i}_slot"] = _np(h.layers_slot[i])
    if art.pq is not None:
        out["pq_codebooks"] = _np(art.pq.codebooks)
        out["pq_codes"] = _np(art.pq.codes)
        if art.pq.rotation is not None:
            out["pq_rotation"] = _np(art.pq.rotation)
    for name, col in (art.metadata or {}).items():
        out[f"meta_{name}"] = np.asarray(col)
    return out


def _assert_same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _ref_artifact(art: pio.IndexArtifact, key) -> rio.IndexArtifact:
    """The reference's IndexArtifact holding the same arrays as a port one
    (jax arrays, the reference's HnswIndex and PQIndex)."""
    hier = art.hierarchy
    if hier is not None:
        hier = jgi.HnswIndex(
            layers_neighbors=tuple(jnp.asarray(_np(a)) for a in hier.layers_neighbors),
            layers_nodes=tuple(jnp.asarray(_np(a)) for a in hier.layers_nodes),
            layers_slot=tuple(jnp.asarray(_np(a)) for a in hier.layers_slot),
            entry_point=jnp.asarray(_np(hier.entry_point)),
            levels=jnp.asarray(_np(hier.levels)))
    pq = art.pq
    if pq is not None:
        pq = jpq.PQIndex(codebooks=jnp.asarray(_np(pq.codebooks)),
                         codes=jnp.asarray(_np(pq.codes)), M=pq.M, K=pq.K,
                         rotation=None if pq.rotation is None
                         else jnp.asarray(_np(pq.rotation)))
    return rio.IndexArtifact(base=jnp.asarray(_np(art.base)),
                             neighbors=jnp.asarray(_np(art.neighbors)), metric=art.metric,
                             key=key, hierarchy=hier, pq=pq,
                             hubs=jnp.asarray(_np(art.hubs)), metadata=art.metadata)


SHARDINGS = {"npz": dict(), "f32_shards": dict(shard_rows=400),
             "bf16_shards": dict(shard_rows=400, shard_dtype="bf16")}


@pytest.mark.parametrize("sharding", sorted(SHARDINGS))
@pytest.mark.parametrize("build", sorted(BUILDS))
def test_port_artifact_reads_in_reference(world, build, sharding, tmp_path):
    _, _, searchers = world
    s, _ = searchers[build]
    art = pio.IndexArtifact.from_searcher(s, {"note": "port"})
    path = pio.save_index(str(tmp_path / "a"), art, **SHARDINGS[sharding])
    ref = rio.load_index(path)
    want = _arrays(art)
    if sharding == "bf16_shards":
        want["base"] = np.asarray(jnp.asarray(want["base"]).astype(jnp.bfloat16)
                                  .astype(jnp.float32))
    want["key"] = np.asarray(jax.random.PRNGKey(SEED))
    _assert_same_arrays(_arrays(ref), want)
    assert ref.version == rio.ARTIFACT_VERSION and ref.provenance == {"note": "port"}
    m = json.loads(str(np.load(path)["manifest"][()]))
    assert m["key_impl"] == "raw" and m["metadata"] == sorted(s.metadata)
    assert m["degree_stats"] == {"out": jgi.degree_distribution(np.asarray(ref.neighbors)),
                                 "in": jgi.in_degree_distribution(np.asarray(ref.neighbors))}
    if sharding != "npz":
        shards, dtype = rio.open_base_shards(path)
        assert dtype == SHARDINGS[sharding].get("shard_dtype", "f32")
        assert [x.shape[0] for x in shards] == [400, 400, 400, 300]


@pytest.mark.parametrize("sharding", sorted(SHARDINGS))
@pytest.mark.parametrize("build", sorted(BUILDS))
def test_reference_artifact_reads_in_port(world, build, sharding, tmp_path):
    _, _, searchers = world
    s, _ = searchers[build]
    port_art = pio.IndexArtifact.from_searcher(s)
    path = rio.save_index(str(tmp_path / "r"), _ref_artifact(port_art, jax.random.PRNGKey(SEED)),
                          **SHARDINGS[sharding])
    got = pio.load_index(path)
    want = _arrays(rio.load_index(path))
    _assert_same_arrays(_arrays(got), want)
    assert got.rng_seed == SEED and got.key_impl == "raw"
    if sharding == "bf16_shards":  # the reference's bf16 shards, read without ml_dtypes
        shards, dtype = pio.open_base_shards(path)
        ref_shards, _ = rio.open_base_shards(path)
        assert dtype == "bf16" and shards[0].dtype == np.uint16
        for a, b in zip(shards, ref_shards):
            np.testing.assert_array_equal(a, np.asarray(b).view(np.uint16))


@pytest.mark.parametrize("case", sorted(SEARCHES))
def test_reloaded_search_is_bit_identical(world, case, tmp_path):
    """Save, load, search: ids, dists, n_comps, n_steps and bytes equal the
    searcher before the save, from the same seed."""
    _, queries, searchers = world
    build, kw = SEARCHES[case]
    s, _ = searchers[build]
    q = torch.from_numpy(queries)
    spec = s.spec(**kw)
    want = s.search(q, spec, 11)
    path = pio.save_index(str(tmp_path / "s"), pio.IndexArtifact.from_searcher(s),
                          shard_rows=500)
    got = pio.load_index(path).to_searcher("cpu").search(q, spec, 11)
    for f in ("ids", "dists", "n_comps", "bytes_touched"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.n_steps) == int(want.n_steps)


@pytest.mark.parametrize("case", sorted(c for c in SEARCHES if "restarts" not in c))
def test_reloaded_search_matches_reference(world, case, tmp_path):
    """One artifact, reloaded by both packages: the port searcher given the
    reference's entries answers as the reference's does."""
    _, queries, searchers = world
    build, kw = SEARCHES[case]
    s, _ = searchers[build]
    path = pio.save_index(str(tmp_path / "m"), pio.IndexArtifact.from_searcher(s))
    rs = rio.load_index(path).to_searcher()
    ps = pio.load_index(path).to_searcher("cpu")
    jspec = JSpec(metric="l2", **kw)
    jq = jnp.asarray(queries)
    ent, ec = rs.seed(jq, jspec)
    want = rs.search(jq, jspec, entries=ent, entry_comps=ec)
    got = ps.search(torch.from_numpy(queries), ps.spec(**kw),
                    entries=torch.from_numpy(np.array(ent, np.int32)),
                    entry_comps=torch.from_numpy(np.array(ec, np.int32)))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.n_comps.numpy(), np.asarray(want.n_comps))
    np.testing.assert_array_equal(got.bytes_touched.numpy(), np.asarray(want.bytes_touched))
    assert int(got.n_steps) == int(want.n_steps)
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), **DIST_TOL)


def test_loaded_pq_is_attached_never_retrained(world, tmp_path, monkeypatch):
    _, queries, searchers = world
    s, _ = searchers["gd_pq"]
    path = pio.save_index(str(tmp_path / "p"), pio.IndexArtifact.from_searcher(s))
    ps = pio.load_index(path).to_searcher("cpu")
    from repro_torch.baselines import pq as ppq

    def no_training(*a, **k):
        raise AssertionError("a loaded PQ table was retrained")

    monkeypatch.setattr(ppq, "build_pq", no_training)
    spec = ps.spec(ef=32, k=5, scorer="pq", **PQ)
    assert ps.pq_index(spec) is ps.pq
    ps.search(torch.from_numpy(queries), spec, 3)


def test_legacy_v0_loads_with_hubs_recomputed(world, tmp_path):
    """The pre-manifest {base, neighbors, metric} file loads as v0 in both
    packages, with the same hubs and degree statistics."""
    base, queries, searchers = world
    s, _ = searchers["flat"]
    path = str(tmp_path / "legacy.npz")
    np.savez(path, base=base, neighbors=s.neighbors.numpy(), metric="l2")
    got, want = pio.load_index(path), rio.load_index(path)
    assert got.version == 0 and got.provenance == {"legacy": True}
    assert got.key is None and got.rng_seed == 0
    _assert_same_arrays(_arrays(got), _arrays(want))
    assert got.degree_stats == want.degree_stats
    res = got.to_searcher("cpu").search(torch.from_numpy(queries),
                                        got.to_searcher("cpu").spec(ef=24, k=1), 1)
    assert res.ids.shape == (NQ, 1)


def test_v1_without_hubs_recomputes_them(world, tmp_path):
    _, _, searchers = world
    s, res = searchers["gd_pq"]
    path = pio.save_index(str(tmp_path / "v1"), pio.IndexArtifact.from_searcher(s))
    blob = dict(np.load(path, allow_pickle=False))
    m = json.loads(str(blob.pop("manifest")[()]))
    m["version"] = 1
    del m["n_hubs"], m["degree_stats"]
    del blob["hubs"]
    np.savez(path, manifest=np.array(json.dumps(m)), **blob)
    got, want = pio.load_index(path), rio.load_index(path)
    assert got.version == 1
    _assert_same_arrays(_arrays(got), _arrays(want))
    np.testing.assert_array_equal(got.hubs.numpy(), res.hubs.numpy())
    assert got.degree_stats == want.degree_stats


def test_v3_without_shards_loads_unchanged(world, tmp_path):
    _, queries, searchers = world
    s, _ = searchers["gd_pq"]
    path = pio.save_index(str(tmp_path / "v3"), pio.IndexArtifact.from_searcher(s))
    blob = dict(np.load(path, allow_pickle=False))
    m = json.loads(str(blob.pop("manifest")[()]))
    m["version"] = 3
    del m["shards"]
    del m["pq"]["rotation"]
    np.savez(path, manifest=np.array(json.dumps(m)), **blob)
    got = pio.load_index(path)
    assert got.version == 3 and got.pq.rotation is None
    _assert_same_arrays(_arrays(got), _arrays(rio.load_index(path)))
    spec = s.spec(ef=32, k=5, scorer="pq", **PQ)
    q = torch.from_numpy(queries)
    a, b = s.search(q, spec, 2), got.to_searcher("cpu").search(q, spec, 2)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)


def _corrupt(kind, path, shards):
    if kind == "truncated_npz":
        blob = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(blob[: len(blob) // 2])
    elif kind == "missing_shard":
        os.unlink(shards[2])
    elif kind == "truncated_shard":
        blob = open(shards[1], "rb").read()
        with open(shards[1], "wb") as f:
            f.write(blob[: len(blob) // 2])
    elif kind == "shard_shape":
        np.save(shards[0], np.zeros((5, D), np.float32))
    else:
        blob = dict(np.load(path, allow_pickle=False))
        m = json.loads(str(blob.pop("manifest")[()]))
        if kind == "newer_version":
            m["version"] = pio.ARTIFACT_VERSION + 1
        elif kind == "wrong_magic":
            m["format"] = "someone-else/artifact"
        elif kind == "hubs_mismatch":
            blob["hubs"] = blob["hubs"][:3]
        np.savez(path, manifest=np.array(json.dumps(m)), **blob)


CORRUPTIONS = {"truncated_npz": "not a readable", "missing_shard": "missing",
               "truncated_shard": "unreadable|disagrees", "shard_shape": "disagrees",
               "newer_version": "newer", "wrong_magic": "format", "hubs_mismatch": "n_hubs"}


@pytest.mark.parametrize("kind", sorted(CORRUPTIONS))
def test_corrupt_artifacts_raise_the_named_error(world, kind, tmp_path):
    """Each damage raises the port's CorruptArtifactError, where the
    reference raises ValueError (its CorruptArtifactError or a plain one)."""
    _, _, searchers = world
    s, _ = searchers["flat"]
    path = pio.save_index(str(tmp_path / "c"), pio.IndexArtifact.from_searcher(s),
                          shard_rows=500)
    shards = [str(tmp_path / f) for f in pio.shard_file_names(path, 3)]
    _corrupt(kind, path, shards)
    with pytest.raises(pio.CorruptArtifactError, match=CORRUPTIONS[kind]):
        pio.load_index(path)
    with pytest.raises(ValueError):
        rio.load_index(path)
    if "shard" in kind:
        with pytest.raises(pio.CorruptArtifactError):
            pio.open_base_shards(path)


def test_save_killed_mid_write_keeps_the_old_artifact(world, tmp_path, monkeypatch):
    _, _, searchers = world
    path = str(tmp_path / "index.npz")
    pio.save_index(path, pio.IndexArtifact.from_searcher(searchers["flat"][0]))
    before = open(path, "rb").read()
    real_savez = np.savez

    def dying_savez(f, **arrays):
        real_savez(f, **arrays)
        raise KeyboardInterrupt("killed mid-save")

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(KeyboardInterrupt):
        pio.save_index(path, pio.IndexArtifact.from_searcher(searchers["gd_pq"][0]))
    monkeypatch.undo()
    assert open(path, "rb").read() == before
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []
    assert pio.load_index(path).n == N


def test_suffixless_path_is_normalized(world, tmp_path):
    _, _, searchers = world
    p = pio.save_index(str(tmp_path / "noext"),
                       pio.IndexArtifact.from_searcher(searchers["flat"][0]))
    assert p.endswith(".npz") and os.path.exists(p) and pio.exists(str(tmp_path / "noext"))
    assert pio.load_index(str(tmp_path / "noext")).n == N
    assert rio.load_index(str(tmp_path / "noext")).n == N


@pytest.mark.parametrize("key_kind", ["prng_key", "folded", "typed"])
def test_key_payload_round_trips_both_ways(world, key_kind, tmp_path):
    """The reference's key comes across as an opaque payload: [0, s] gives
    rng_seed s, any other payload the crc32 of its bytes, and a port re-save
    writes it back unchanged (impl tag included)."""
    _, _, searchers = world
    s, _ = searchers["flat"]
    key = {"prng_key": jax.random.PRNGKey(12345),
           "folded": jax.random.fold_in(jax.random.PRNGKey(3), 9),
           "typed": jax.random.key(77)}[key_kind]
    path = rio.save_index(str(tmp_path / "k"),
                          _ref_artifact(pio.IndexArtifact.from_searcher(s), key))
    art = pio.load_index(path)
    payload = _np(key).astype(np.uint32)
    np.testing.assert_array_equal(art.key, payload)
    assert art.key_impl == ("typed" if key_kind == "typed" else "raw")
    want_seed = (int(payload[1]) if payload[0] == 0
                 else zlib.crc32(np.ascontiguousarray(payload).tobytes()))
    assert art.rng_seed == want_seed
    ps = art.to_searcher("cpu")
    assert ps.rng_seed == want_seed
    again = pio.save_index(str(tmp_path / "k2"), pio.IndexArtifact.from_searcher(ps))
    back = rio.load_index(again)
    np.testing.assert_array_equal(_np(back.key), payload)
    if key_kind == "typed":
        assert jnp.issubdtype(back.key.dtype, jax.dtypes.prng_key)


def test_port_key_is_the_references_prng_key(world, tmp_path):
    _, _, searchers = world
    s, _ = searchers["flat"]
    for seed in (0, 1, 2**32 - 1):
        s.rng_seed, s.key = seed, None
        path = pio.save_index(str(tmp_path / f"s{seed}"), pio.IndexArtifact.from_searcher(s))
        np.testing.assert_array_equal(np.asarray(rio.load_index(path).key),
                                      np.asarray(jax.random.PRNGKey(seed)))
    s.rng_seed = SEED
    with pytest.raises(ValueError, match="rng_seed"):
        pio.key_payload(2**32)
