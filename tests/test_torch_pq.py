"""The quantization ladder's tables: the sq8 table and the PQ baseline
(``baselines/pq.py``), held against live calls into ``repro`` on the CPU.

The sq8 table is deterministic and must be bit-identical. PQ codebooks are
trained from ``torch.Generator`` draws, so training is held statistically
(quantization MSE within 5% of the reference's, same-seed rebuilds
identical); given the reference's codebooks, encoding, LUTs and search are
held exactly, up to float32 near-ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import pq as jpq
from repro.core import scorers as jscorers
from repro_torch.baselines import pq
from repro_torch.core import convert, scorers
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

METRICS = ["l2", "ip", "cos"]
N, D, M, K, ITERS = 2000, 16, 4, 32, 5
MSE_SLACK = 0.05


def _t(a, dtype=torch.float32):
    return convert.tensor(a, dtype, device="cpu")


@pytest.fixture(scope="module")
def world():
    """A base with per-dimension scales (anisotropic, as OPQ wants), queries,
    and the reference's PQ and OPQ tables on it."""
    rng = np.random.default_rng(0)
    base = (rng.standard_normal((N, D), dtype=np.float32)
            * np.linspace(0.2, 2.0, D, dtype=np.float32))
    queries = rng.standard_normal((40, D), dtype=np.float32)
    key = jax.random.PRNGKey(1)
    jb = jnp.asarray(base)
    return {"base": base, "queries": queries,
            "pq": jpq.build_pq(jb, M=M, K=K, iters=ITERS, key=key),
            "opq": jpq.build_opq(jb, M=M, K=K, iters=ITERS, key=key, opq_iters=2)}


def _carried(idx):
    return convert.pq_index_from_numpy(
        np.asarray(idx.codebooks), np.asarray(idx.codes),
        None if idx.rotation is None else np.asarray(idx.rotation), device="cpu")


def _mse(base: np.ndarray, recon: np.ndarray, rotation=None) -> float:
    x = base.astype(np.float64)
    if rotation is not None:
        x = x @ np.asarray(rotation, np.float64)
    return float(((x - recon.astype(np.float64)) ** 2).sum(1).mean())


# -- sq8 ----------------------------------------------------------------------


def test_build_sq8_is_bit_identical_to_the_reference():
    """Codes, scale and mn identical, including a zero-range dimension
    (scale 1, codes 0) and values exactly half a step from a boundary
    (round half to even)."""
    rng = np.random.default_rng(2)
    base = rng.standard_normal((1500, 24), dtype=np.float32) * 3
    base[:, 5] = 0.75                       # zero range
    base[:, 7] = np.arange(1500) % 5        # integer grid: exact halves
    base[0, 7], base[1, 7] = 0.0, 510.0     # range 510 -> scale 2 -> k + 0.5
    got = scorers.build_sq8(_t(base))
    want = jscorers.build_sq8(jnp.asarray(base))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.mn.numpy(), np.asarray(want.mn))
    assert got.codes.dtype == torch.uint8 and float(got.scale[5]) == 1.0
    assert (got.codes[:, 5] == 0).all()
    carried = convert.sq8_from_numpy(np.asarray(want.codes), np.asarray(want.scale),
                                     np.asarray(want.mn), device="cpu")
    for a, b in zip(carried, got):
        assert torch.equal(a, b)


# -- PQ given the reference's codebooks ---------------------------------------


@pytest.mark.parametrize("which", ["pq", "opq"])
def test_encode_matches_reference_up_to_near_ties(world, which):
    """At most 0.1% of codes differ, and where one does, the two chosen
    centroids are equally near to 1e-5 relative."""
    idx = world[which]
    rot = None if idx.rotation is None else np.asarray(idx.rotation)
    x = world["base"] if rot is None else world["base"] @ rot
    cb = np.asarray(idx.codebooks)
    got = pq._encode(_t(x), _t(cb)).numpy()
    want = np.asarray(jpq._encode(jnp.asarray(x), jnp.asarray(cb)))
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.argwhere(got != want)
    assert len(diff) <= 0.001 * got.size, len(diff)
    dsub = D // M
    for i, m in diff:
        sub = x[i, m * dsub:(m + 1) * dsub].astype(np.float64)
        dg = ((sub - cb[m, got[i, m]]) ** 2).sum()
        dw = ((sub - cb[m, want[i, m]]) ** 2).sum()
        assert abs(dg - dw) <= 1e-5 * max(dw, 1e-12), (i, m, dg, dw)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("which", ["pq", "opq"])
def test_adc_luts_match_reference(world, metric, which):
    """build_adc_luts through the engine's scorer_state (queries rotated
    first under OPQ) against the reference's, within rtol 1e-5."""
    idx = world[which]
    carried = _carried(idx)
    s = convert.searcher_from_numpy(world["base"], np.zeros((N, 1), np.int32),
                                    metric=metric, pq=carried, device="cpu")
    spec = s.spec(scorer="pq", pq_m=M, pq_k=K)
    codes, luts = s.scorer_state(_t(world["queries"]), spec)
    q = jnp.asarray(world["queries"])
    if idx.rotation is not None:
        q = q @ idx.rotation
    want = jpq.build_adc_luts(q, idx.codebooks, metric)
    np.testing.assert_allclose(luts.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert codes is carried.codes


@pytest.mark.parametrize("k,rerank", [(1, 64), (10, 32)])
def test_pq_search_matches_reference(world, k, rerank, monkeypatch):
    """Identical comps; identical ids except where two candidates' exact
    distances tie within 1e-5; dists within rtol 1e-5. The 40 queries go
    through the scan in three chunks."""
    monkeypatch.setattr(pq, "SEARCH_CHUNK", 16)
    idx = world["pq"]
    got_d, got_i, got_c = pq.pq_search(_t(world["queries"]), _t(world["base"]),
                                       _carried(idx), k=k, rerank=rerank)
    want_d, want_i, want_c = jpq.pq_search(jnp.asarray(world["queries"]),
                                           jnp.asarray(world["base"]), idx, k=k,
                                           rerank=rerank)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert int(got_c[0]) == int(N * M / D) + rerank
    diff = got_i.numpy() != np.asarray(want_i)
    assert diff.mean() <= 0.01, diff.mean()
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-6)


def test_reconstruct_matches_reference(world):
    idx = world["opq"]
    np.testing.assert_array_equal(pq.reconstruct(_carried(idx)).numpy(),
                                  np.asarray(jpq.reconstruct(idx)))


# -- PQ training, statistically -----------------------------------------------


@pytest.mark.parametrize("which", ["pq", "opq"])
def test_training_mse_within_5pct_of_reference(world, which):
    """Quantization MSE of the port's build_pq / build_opq within 5% of the
    reference's on the same base (different generators, same algorithm)."""
    base = world["base"]
    if which == "pq":
        got = pq.build_pq(_t(base), M=M, K=K, iters=ITERS, key=1)
    else:
        got = pq.build_opq(_t(base), M=M, K=K, iters=ITERS, key=1, opq_iters=2)
    want = world[which]
    rot_g = None if got.rotation is None else got.rotation.numpy()
    mse_g = _mse(base, pq.reconstruct(got).numpy(), rot_g)
    mse_w = _mse(base, np.asarray(jpq.reconstruct(want)),
                 None if want.rotation is None else np.asarray(want.rotation))
    assert abs(mse_g - mse_w) <= MSE_SLACK * mse_w, (mse_g, mse_w)
    assert got.codes.shape == (N, M) and got.codebooks.shape == (M, K, D // M)
    assert (got.M, got.K) == (M, K)


def test_same_seed_rebuilds_are_identical(world):
    base = _t(world["base"][:600])
    for build in (lambda s: pq.build_pq(base, M=M, K=16, iters=3, key=s),
                  lambda s: pq.build_opq(base, M=M, K=16, iters=3, key=s, opq_iters=1)):
        a, b, c = build(7), build(7), build(8)
        assert torch.equal(a.codebooks, b.codebooks) and torch.equal(a.codes, b.codes)
        assert not torch.equal(a.codebooks, c.codebooks)
        if a.rotation is not None:
            assert torch.equal(a.rotation, b.rotation)


def test_key_derivations_are_distinct_and_deterministic():
    assert pq.derive_pq_key(0) == pq.derive_pq_key(0)
    assert len({pq.derive_pq_key(0), pq.derive_pq_key(1), pq.derive_opq_key(0),
                pq.derive_opq_key(1)}) == 4


def test_build_pq_rejects_what_uint8_codes_cannot_hold():
    base = torch.zeros((300, 8))
    with pytest.raises(ValueError, match="uint8"):
        pq.build_pq(base, M=4, K=257)
    with pytest.raises(ValueError, match="divide"):
        pq.build_pq(base, M=3)
    with pytest.raises(ValueError, match="k <= n"):
        pq.build_pq(base[:10], M=4, K=16)


def test_kmeans_from_the_reference_draw_gives_its_codebooks():
    """Given the reference's initial centroids (its ``jax.random.choice``
    draw, ``repro/baselines/pq.py`` ``_kmeans``) on each sub-space of the
    serving smoke world (n=20_000, d=32, M=8, K=256, 15 iterations, the
    build-time key of seed 0), the port's k-means lands on the reference's
    codebooks to 1e-5 (float32 sums in another order; no cluster empties, so
    no re-seed draw is taken). The two differ only in their draws."""
    from repro_torch.launch.serve import SMOKE_WORLD, numpy_world

    n, d = SMOKE_WORLD
    m_sub, k, iters = 8, 256, 15
    base = numpy_world(n, d, 0)
    key = jpq.derive_pq_key(jax.random.PRNGKey(0))
    want = np.asarray(jpq._train(key, jnp.asarray(base), m_sub, k, iters))
    subs = base.reshape(n, m_sub, d // m_sub)
    for m, sub_key in enumerate(jax.random.split(key, m_sub)):
        ids = np.asarray(jax.random.choice(sub_key, n, shape=(k,), replace=False))
        x = _t(subs[:, m])
        got = pq._kmeans(0, x, k, iters, init=x[torch.from_numpy(ids).long()])
        np.testing.assert_allclose(got.numpy(), want[m], rtol=0, atol=1e-5,
                                   err_msg=f"sub-space {m}")
    with pytest.raises(ValueError, match="init must be"):
        pq._kmeans(0, x, k, iters, init=x[:3])
