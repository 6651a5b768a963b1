"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each skips inside its fixture where no GPU is visible. This
file imports neither jax nor repro, so it runs where only the port is
installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.core import convert, nndescent
from repro_torch.kernels import distance_matrix as cuda_dm
from repro_torch.kernels import flash_attention as cuda_fa
from repro_torch.kernels import gather_adc as cuda_ga
from repro_torch.kernels import gather_distance as cuda_gd
from repro_torch.kernels import gather_distance_pool as cuda_gp
from repro_torch.kernels import gather_sq8 as cuda_gs
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pq_adc as cuda_pa
from torch_pool import chunked_pass, pool_world

METRICS = ["l2", "ip", "cos"]
# float32 sums in another order than the plain version's
GATHER_TOL = dict(rtol=1e-5, atol=1e-5)


def _gather_tol(d):
    """GATHER_TOL up to d = 128; past it the absolute tolerance grows as
    d / 64, as the sums that kernel and plain version order differently do
    (the generic gather kernel is 6.1e-5 from the plain version for ip at
    d = 960, on the H100)."""
    return GATHER_TOL if d <= 128 else dict(rtol=1e-5, atol=1e-5 * d / 64)


def _world(Q, R, n, d, seed=0):
    """queries, base, ids with padding (-1), one all-invalid row, ids on bit
    31 and in the last word, and a random uint32 visited bitmap."""
    rng = np.random.default_rng(seed + 7 * Q + R + d)
    queries = rng.standard_normal((Q, d), dtype=np.float32)
    base = rng.standard_normal((n, d), dtype=np.float32)
    ids = rng.integers(-1, n, size=(Q, R)).astype(np.int32)
    if Q > 1:
        ids[0] = -1
    if Q > 2 and R >= 3:
        ids[1, :3] = [min(31, n - 1), n - 1, ((n - 1) // 32) * 32]
    visited = rng.integers(0, 2**32, size=(Q, (n + 31) // 32), dtype=np.uint64)
    return queries, base, ids, visited.astype(np.uint32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _c(a, dev, dtype=torch.float32):
    return convert.tensor(a, dtype, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("Q,R,n,d", [(64, 20, 5000, 64), (7, 33, 1000, 17),
                                     (3, 240, 300, 64), (1, 1, 1, 1)])
def test_cuda_gather_kernels_match_plain(cuda, metric, Q, R, n, d):
    queries, base, ids, visited = _world(Q, R, n, d, seed=4)
    qt, it, bt = _c(queries, cuda), _c(ids, cuda, torch.int32), _c(base, cuda)
    vt = convert.bitmap_from_uint32(visited, cuda)
    want = ref.gather_distance_ref(qt, it, bt, metric)
    for gather in (cuda_gd.gather_distance, cuda_gd.gather_distance_generic):
        torch.testing.assert_close(gather(qt, it, bt, metric), want, **GATHER_TOL)
    want_d, want_i = ref.gather_distance_masked_ref(qt, it, bt, vt, metric)
    for masked in (cuda_gd.gather_distance_masked, cuda_gd.gather_distance_masked_generic):
        got_d, got_i = masked(qt, it, bt, vt, metric)
        assert torch.equal(got_i, want_i)
        torch.testing.assert_close(got_d, want_d, **GATHER_TOL)


def _hop_world(Q, R, n, d, seed):
    """_world's hop inputs with what the beam's hop kernel must mask: an
    all-padding row (0), a row whose every id is visited (2), ids past
    n - 1 (row 3), bit 31 and the last word (row 1)."""
    queries, base, ids, visited = _world(Q, R, n, d, seed)
    if Q > 2:
        visited[2] = np.uint32(0xFFFFFFFF)
    if Q > 3:
        ids[3, ::2] = n + np.arange(len(ids[3, ::2]), dtype=np.int32) % 40
    return queries, base, ids, visited


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("Q,R,n", [(64, 20, 5000), (7, 33, 1000), (5, 3, 70), (1, 1, 1)])
def test_cuda_hop_kernel_is_bit_identical_to_the_generic_kernel(cuda, metric, d, Q, R, n):
    """The beam's hop kernel (one 8-lane group a pair) gives the generic
    masked kernel's distances and ids bit for bit where d is a multiple of
    32: R not a multiple of a block's 16 pairs, an all-padding row, a row
    with every id visited, ids past n - 1."""
    queries, base, ids, visited = _hop_world(Q, R, n, d, seed=8)
    qt, it, bt = _c(queries, cuda), _c(ids, cuda, torch.int32), _c(base, cuda)
    vt = convert.bitmap_from_uint32(visited, cuda)
    got_d, got_i = cuda_gd.gather_distance_masked(qt, it, bt, vt, metric)
    gen_d, gen_i = cuda_gd.gather_distance_masked_generic(qt, it, bt, vt, metric)
    assert torch.equal(got_i, gen_i) and torch.equal(got_d, gen_d)
    want_d, want_i = ref.gather_distance_masked_ref(qt, it, bt, vt, metric)
    assert torch.equal(got_i, want_i)
    torch.testing.assert_close(got_d, want_d, **GATHER_TOL)
    if Q > 3:
        assert (got_i[0] == -1).all() and torch.isinf(got_d[0]).all()
        assert (got_i[2] == -1).all() and torch.isinf(got_d[2]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [1, 5, 17, 50, 130, 960])
def test_cuda_hop_kernel_matches_plain_at_ragged_d(cuda, metric, d):
    """Other d (scalar loads where d % 4 != 0): ids identical, distances
    within _gather_tol(d) of the plain version; a query row at a 4-byte
    offset takes the scalar path too."""
    queries, base, ids, visited = _hop_world(9, 37, 700, d, seed=9)
    it, bt = _c(ids, cuda, torch.int32), _c(base, cuda)
    vt = convert.bitmap_from_uint32(visited, cuda)
    flat = torch.zeros(queries.size + 1, device=cuda)
    flat[1:] = _c(queries, cuda).flatten()
    for qt in (_c(queries, cuda), flat[1:].view(queries.shape)):
        got_d, got_i = cuda_gd.gather_distance_masked(qt, it, bt, vt, metric)
        want_d, want_i = ref.gather_distance_masked_ref(qt, it, bt, vt, metric)
        assert torch.equal(got_i, want_i)
        torch.testing.assert_close(got_d, want_d, **_gather_tol(d))


def _pair_world(Q, R, n, d, seed):
    """_world's ids with what the unmasked gather meets on the hierarchy
    path: rows that are all padding (0 and, where Q > 4, 4: a descent step's
    finished rows), a row with ids past n - 1 (3)."""
    queries, base, ids, _ = _world(Q, R, n, d, seed)
    ids[0] = -1
    if Q > 3:
        ids[3, ::2] = n + np.arange(len(ids[3, ::2]), dtype=np.int32) % 40
    if Q > 4:
        ids[4] = -1
    return queries, base, ids


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [32, 64, 130, 960])
@pytest.mark.parametrize("Q,R,n", [(64, 1, 5000), (64, 10, 5000), (64, 32, 5000),
                                   (64, 64, 5000), (7, 33, 1000), (1, 1, 1)])
def test_cuda_pair_kernel_is_bit_identical_to_the_generic_kernel(cuda, metric, d, Q, R, n):
    """The unmasked pair kernel (one 8-lane group a pair) gives the generic
    kernel's distances bit for bit at the hierarchy path's R (a layer start,
    a descent step, the hubs scan, the rerank), ragged d included: padding
    rows +inf, ids past n - 1 read row n - 1; a query row at a 4-byte
    offset (scalar loads) too."""
    queries, base, ids = _pair_world(Q, R, n, d, seed=12)
    it, bt = _c(ids, cuda, torch.int32), _c(base, cuda)
    flat = torch.zeros(queries.size + 1, device=cuda)
    flat[1:] = _c(queries, cuda).flatten()
    for qt in (_c(queries, cuda), flat[1:].view(queries.shape)):
        ops.reset_launch_counts()
        got = cuda_gd.gather_distance(qt, it, bt, metric)
        gen = cuda_gd.gather_distance_generic(qt, it, bt, metric)
        assert torch.equal(got, gen)
        counts = ops.launch_counts()
        assert counts["gather_distance"] == 1 and counts["gather_distance_generic"] == 1
        torch.testing.assert_close(got, ref.gather_distance_ref(qt, it, bt, metric),
                                   **_gather_tol(d))
        assert torch.isinf(got[0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [4, 128])
@pytest.mark.parametrize("Q,R,n", [(1000, 20, 30001), (64, 1824, 30001), (7, 33, 1000)])
def test_cuda_paper_shapes_match_plain(cuda, metric, d, Q, R, n):
    """The paper path's shapes: a hop of 1,000 queries x R=20 and the
    forest rerank's R = 12 x 152 = 1,824, at d=4 (RAND10M4D: half the
    lanes of each 8-lane group hold no column) and d=128 (SIFT1M). The pair
    kernel bit for bit against the generic kernel and within GATHER_TOL of
    the plain version; the hop kernel's ids identical to the plain
    version's, its distances within GATHER_TOL, and bit for bit against
    the generic masked kernel where d % 32 == 0."""
    queries, base, ids, visited = _hop_world(Q, R, n, d, seed=14)
    qt, it, bt = _c(queries, cuda), _c(ids, cuda, torch.int32), _c(base, cuda)
    vt = convert.bitmap_from_uint32(visited, cuda)
    got = cuda_gd.gather_distance(qt, it, bt, metric)
    assert torch.equal(got, cuda_gd.gather_distance_generic(qt, it, bt, metric))
    torch.testing.assert_close(got, ref.gather_distance_ref(qt, it, bt, metric), **GATHER_TOL)
    got_d, got_i = cuda_gd.gather_distance_masked(qt, it, bt, vt, metric)
    want_d, want_i = ref.gather_distance_masked_ref(qt, it, bt, vt, metric)
    assert torch.equal(got_i, want_i)
    torch.testing.assert_close(got_d, want_d, **GATHER_TOL)
    if d % 32 == 0:
        gen_d, gen_i = cuda_gd.gather_distance_masked_generic(qt, it, bt, vt, metric)
        assert torch.equal(got_d, gen_d) and torch.equal(got_i, gen_i)


@pytest.mark.cuda
def test_cuda_pair_kernel_takes_d_past_the_generic_limit(cuda):
    """The pair kernel stages nothing: d past the generic kernel's 48 KB
    query row runs (against the plain version), where the generic kernel
    raises."""
    d = cuda_gd.GENERIC_MAX_D + 4
    queries, base, ids = _pair_world(3, 5, 20, d, seed=13)
    qt, it, bt = _c(queries, cuda), _c(ids, cuda, torch.int32), _c(base, cuda)
    assert cuda_gd.gather_route(3, 5, 20, d) == ("pairs", 1)
    got = ops.gather_distance(qt, it, bt)
    torch.testing.assert_close(got, ref.gather_distance_ref(qt, it, bt), **_gather_tol(d))
    with pytest.raises(ValueError, match="unsupported shape"):
        cuda_gd.gather_distance_generic(qt, it, bt)


def _gather_kernel_pass(base, pool, metric, chunk=1024):
    """The scoring pass as the generic gather kernel ran it: one launch per
    ``chunk`` rows."""
    return chunked_pass(cuda_gd.gather_distance_generic, base, pool, metric, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("windows", ["card", "many"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [32, 64, 128])
def test_cuda_pool_kernel_is_bit_identical_to_the_gather_kernel(cuda, monkeypatch,
                                                                 windows, metric, d):
    """Same bits as the generic gather kernel, for windows planned from the
    card's L2 and for ~40-row windows one call each (many calls)."""
    if windows == "many":
        monkeypatch.setattr(cuda_gp, "L2_SHARE", 1e-3)
        monkeypatch.setattr(cuda_gp, "GROUP_PAIRS", 1 << 14)
    base, pool = pool_world(5000, 240, d)
    bt, pt = _c(base, cuda), _c(pool, cuda, torch.int32)
    got = cuda_gp.gather_distance_pool(bt, pt, metric)
    assert torch.equal(got, _gather_kernel_pass(bt, pt, metric))
    torch.testing.assert_close(got, ref.gather_distance_pool_ref(bt, pt, metric),
                               **GATHER_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n,C,d", [(3000, 240, 8), (3000, 20, 17), (1, 1, 64),
                                   (30001, 240, 64), (7, 3, 5), (30001, 4, 960)])
def test_cuda_pool_kernel_matches_plain(cuda, metric, n, C, d):
    """Other d within GATHER_TOL of the plain version; n = 1, C = 1; n past
    one window of the card's L2 with a ragged tail; all-INVALID rows; a
    shape the plan sends to the direct kernel (d = 960, C = 4; _gather_tol)."""
    base, pool = pool_world(n, C, d, seed=1)
    bt, pt = _c(base, cuda), _c(pool, cuda, torch.int32)
    got = cuda_gp.gather_distance_pool(bt, pt, metric)
    torch.testing.assert_close(got, ref.gather_distance_pool_ref(bt, pt, metric),
                               **_gather_tol(d))
    if d % 32 == 0:
        assert torch.equal(got, _gather_kernel_pass(bt, pt, metric))
    none = torch.full_like(pt, -1)
    assert torch.isinf(cuda_gp.gather_distance_pool(bt, none, metric)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,C,d", [(1_000_000, 20, 960), (5_000_000, 20, 8)])
def test_cuda_pool_kernel_takes_the_generic_gathers_shapes(cuda, n, C, d):
    """GIST1M's width at n = 1M and a base past 8192 buckets of 512 rows go
    to the direct kernel (one launch a pass): within _gather_tol(d) of the
    plain version, bit-identical to the generic gather kernel where d is a
    multiple of 32."""
    g = torch.Generator(device=cuda).manual_seed(n + d)
    bt = torch.randn((n, d), generator=g, device=cuda)
    pt = torch.randint(-1, n, (n, C), generator=g, device=cuda, dtype=torch.int32)
    assert cuda_gp.pool_plan(n, d, C, torch.cuda.get_device_properties(cuda).L2_cache_size) \
        is None
    for metric in METRICS:
        before = cuda_gp.LAUNCHES["gather_distance_pool"]
        got = cuda_gp.gather_distance_pool(bt, pt, metric)
        assert cuda_gp.LAUNCHES["gather_distance_pool"] == before + 1
        torch.testing.assert_close(got, ref.gather_distance_pool_ref(bt, pt, metric),
                                   **_gather_tol(d))
        if d % 32 == 0:
            assert torch.equal(got, _gather_kernel_pass(bt, pt, metric))


@pytest.mark.cuda
def test_cuda_nndescent_graph_is_the_gather_kernels(cuda, monkeypatch):
    """A smoke-world NN-Descent build scored by the pool kernel gives the
    graph of the same build scored by the generic gather kernel."""
    base = _c(np.random.default_rng(0).standard_normal((20000, 32), dtype=np.float32),
              cuda)
    cfg = nndescent.NNDescentConfig(rounds=4)
    got, got_stats = nndescent.build_knn_graph_with_stats(base, cfg, seed=0)
    monkeypatch.setattr(nndescent, "_score_chunked",
                        lambda b, p, metric, chunk: _gather_kernel_pass(b, p, metric, chunk))
    want, want_stats = nndescent.build_knn_graph_with_stats(base, cfg, seed=0)
    assert got_stats == want_stats
    assert torch.equal(got.neighbors, want.neighbors)
    assert torch.equal(got.dists, want.dists)

@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", [(1, 512, 16384, 64), (1, 37, 101, 24),
                                   (1000, 20, 20, 64), (5, 7, 3, 130)])
def test_cuda_distance_matrix_matches_plain(cuda, metric, shape):
    B, q, n, d = shape
    rng = np.random.default_rng(B + q + n + d)
    x = _c(rng.standard_normal((B, q, d), dtype=np.float32), cuda)
    y = _c(rng.standard_normal((B, n, d), dtype=np.float32), cuda)
    got = cuda_dm.distance_matrix(x, y, metric)
    want = ref.distance_matrix_ref(x, y, metric)
    # rtol 1e-4: the kernel sums in another order than the library matmul;
    # the expanded l2 form's absolute error grows with the norms (~d here)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * (d if metric == "l2" else 1))
    if B == 1:
        torch.testing.assert_close(cuda_dm.distance_matrix(x[0], y[0], metric),
                                   got[0], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", [(1, 129, 257, 130), (1, 300, 1000, 960),
                                   (2, 130, 260, 64), (3, 200, 150, 64), (1, 33, 5, 7),
                                   (1, 640, 16500, 64)])
def test_cuda_distance_matrix_large_route_matches_plain(cuda, metric, shape):
    """The 128 x 128 route: ragged q / n / d (scalar loads and stores), d =
    960, B > 1, q one past the small route, a ground-truth chunk with ragged
    tiles; zero rows in x and y (cos clamps their norms); an operand at a
    4-byte offset. The tolerance is test_cuda_distance_matrix_matches_plain's."""
    B, q, n, d = shape
    assert cuda_dm.matrix_route(B, q, n, d)[0] == cuda_dm.LARGE_TILE
    rng = np.random.default_rng(B * q + n + d)
    x = _c(rng.standard_normal((B, q, d), dtype=np.float32), cuda)
    y = _c(rng.standard_normal((B, n, d), dtype=np.float32), cuda)
    x[:, 1] = 0.0
    y[:, -1] = 0.0
    flat = torch.zeros(x.numel() + 1, device=cuda)
    flat[1:] = x.flatten()
    tol = dict(rtol=1e-4, atol=1e-4 * (d if metric == "l2" else 1))
    want = ref.distance_matrix_ref(x, y, metric)
    for xs in (x, flat[1:].view(x.shape)):
        got = cuda_dm.distance_matrix(xs, y, metric)
        torch.testing.assert_close(got, want, **tol)
    if metric == "cos":
        assert torch.equal(got[:, 1], torch.ones_like(got[:, 1]))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", ["GD 1000x20x20x64 x is y", "GD 1000x20x20x64 x != y",
                                  "5x7x3x130", "3x32x32x960", "2x1x1x1",
                                  "x at a 4-byte offset", "zero rows"])
def test_cuda_small_route_is_bit_identical_to_the_32_tile(cuda, metric, case):
    """The small route (one warp a matrix) gives the 32 x 32 tile's bits at
    every shape it takes: x is y (one staged copy) and x != y, ragged q / n
    / d (4-byte copies), d = 960 in k-chunks, q = n = 1, an operand at a
    4-byte offset, zero rows (cos clamps their norms); within the plain
    version's tolerance (test_cuda_distance_matrix_matches_plain's)."""
    shape = {"5x7x3x130": (5, 7, 3, 130), "3x32x32x960": (3, 32, 32, 960),
             "2x1x1x1": (2, 1, 1, 1)}.get(case, (1000, 20, 20, 64))
    B, q, n, d = shape
    rng = np.random.default_rng(B + q + n + d + len(case))
    x = _c(rng.standard_normal((B, q, d), dtype=np.float32), cuda)
    y = x if case == "GD 1000x20x20x64 x is y" else _c(
        rng.standard_normal((B, n, d), dtype=np.float32), cuda)
    if case == "x at a 4-byte offset":
        flat = torch.zeros(x.numel() + 1, device=cuda)
        flat[1:] = x.flatten()
        x = flat[1:].view(x.shape)
    if case == "zero rows":
        x[:, 1] = 0.0
        y[:, -1] = 0.0
    assert cuda_dm.matrix_route(B, q, n, d)[0] == cuda_dm.SMALL_TILE
    before = dict(cuda_dm.LAUNCHES)
    got = cuda_dm.distance_matrix(x, y, metric)
    assert cuda_dm.LAUNCHES["distance_matrix_small"] == before["distance_matrix_small"] + 1
    assert torch.equal(got, cuda_dm.distance_matrix_tile32(x, y, metric))
    torch.testing.assert_close(got, ref.distance_matrix_ref(x, y, metric), rtol=1e-4,
                               atol=1e-4 * (d if metric == "l2" else 1))
    if case == "zero rows" and metric == "cos":
        assert torch.equal(got[:, 1], torch.ones_like(got[:, 1]))


def _codes(rng, n, d, M, K, dev):
    """sq8 codes with scale/mn (dimension 0 zero-range: scale 1) and PQ
    codes, on ``dev``."""
    scale = (rng.random(d).astype(np.float32) + 0.1) / 64
    scale[0] = 1.0
    sq = (torch.from_numpy(rng.integers(0, 256, size=(n, d)).astype(np.uint8)).to(dev),
          _c(scale, dev), _c(rng.standard_normal(d, dtype=np.float32), dev))
    pq = torch.from_numpy(rng.integers(0, K, size=(n, M)).astype(np.uint8)).to(dev)
    return sq, pq


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("Q,R,n,d", [(64, 20, 5000, 64), (7, 33, 1000, 17),
                                     (3, 240, 300, 64), (1, 1, 1, 1)])
def test_cuda_gather_sq8_matches_plain(cuda, metric, Q, R, n, d):
    """Masked ids identical, dists within GATHER_TOL (one FMA per
    dequantized value and another summation order than the plain
    version's); the 4-byte code loads and the byte path both."""
    queries, _, ids, visited = _world(Q, R, n, d, seed=5)
    qt, it = _c(queries, cuda), _c(ids, cuda, torch.int32)
    vt = convert.bitmap_from_uint32(visited, cuda)
    (codes, scale, mn), _ = _codes(np.random.default_rng(n + d), n + 1, d, 8, 16, cuda)
    for table in (codes[:n], codes[1:]):   # aligned, and offset by d bytes
        got_d, got_i = cuda_gs.gather_sq8_masked(qt, it, table, scale, mn, vt, metric)
        want_d, want_i = ref.gather_sq8_masked_ref(qt, it, table, scale, mn, vt, metric)
        assert torch.equal(got_i, want_i)
        torch.testing.assert_close(got_d, want_d, **GATHER_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("Q,R,n,d", [(64, 20, 5000, 64), (9, 37, 700, 1), (9, 37, 700, 5),
                                     (9, 37, 700, 17), (9, 37, 700, 50), (9, 37, 700, 100),
                                     (9, 37, 700, 130), (3, 240, 300, 64), (5, 3, 70, 32)])
def test_cuda_sq8_hop_is_bit_identical_to_the_generic_kernel(cuda, metric, Q, R, n, d):
    """The sq8 hop kernel (one 8-lane group a pair) gives the generic sq8
    kernel's distances and ids bit for bit: ragged d on the word path (d %
    4 == 0; 16-byte code loads where d % 16 == 0) and the byte path; a table
    at a 1-byte offset (the byte path at every d); R past 32; Q x R past one
    block of 16 pairs; an all-padding row, a row with every id visited, ids
    past n - 1; within GATHER_TOL of the plain version."""
    queries, _, ids, visited = _hop_world(Q, R, n, d, seed=10)
    qt, it = _c(queries, cuda), _c(ids, cuda, torch.int32)
    vt = convert.bitmap_from_uint32(visited, cuda)
    (codes, scale, mn), _ = _codes(np.random.default_rng(n + d), n + 1, d, 8, 16, cuda)
    raw = torch.zeros((n * d + 1,), dtype=torch.uint8, device=cuda)
    raw[1:] = codes[:n].flatten()
    for table in (codes[:n], raw[1:].view(n, d)):   # aligned, and at a 1-byte offset
        got_d, got_i = cuda_gs.gather_sq8_masked(qt, it, table, scale, mn, vt, metric)
        gen_d, gen_i = cuda_gs.gather_sq8_masked_generic(qt, it, table, scale, mn, vt, metric)
        assert torch.equal(got_i, gen_i) and torch.equal(got_d, gen_d)
        want_d, want_i = ref.gather_sq8_masked_ref(qt, it, table, scale, mn, vt, metric)
        assert torch.equal(got_i, want_i)
        torch.testing.assert_close(got_d, want_d, **GATHER_TOL)
        if Q > 3:
            assert (got_i[0] == -1).all() and torch.isinf(got_d[0]).all()
            assert (got_i[2] == -1).all() and torch.isinf(got_d[2]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 16, 4])
@pytest.mark.parametrize("Q,R,n,K", [(64, 20, 5000, 256), (7, 33, 1000, 16),
                                     (1, 1, 1, 1)])
def test_cuda_adc_kernels_match_plain_bitwise(cuda, M, Q, R, n, K):
    """gather_adc_masked and pq_adc sum in the plain versions' m order:
    scores bit-identical, masked ids identical, on every kernel and route;
    8-byte and byte code loads both."""
    rng = np.random.default_rng(M + Q + n)
    _, _, ids, visited = _world(Q, R, n, 4, seed=6)
    it, vt = _c(ids, cuda, torch.int32), convert.bitmap_from_uint32(visited, cuda)
    _, codes = _codes(rng, n + 1, 4, M, K, cuda)
    luts = _c(rng.standard_normal((Q, M, K), dtype=np.float32), cuda)
    for table in (codes[:n], codes[1:]):   # aligned, and offset by M bytes
        want_d, want_i = ref.gather_adc_masked_ref(it, table, luts, vt)
        for hop in (cuda_ga.gather_adc_masked, cuda_ga.gather_adc_masked_generic):
            got_d, got_i = hop(it, table, luts, vt)
            assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
        for scan in (cuda_pa.pq_adc, cuda_pa.pq_adc_generic):
            assert torch.equal(scan(table, luts), ref.pq_adc_ref(table, luts))
            assert torch.equal(scan(table, luts[0]), ref.pq_adc_ref(table, luts[0]))


def _adc_hop_world(Q, R, n, M, K, seed):
    """ids with padding, an all-padding row, a row whose ids are all
    visited, a row of ids past n - 1; codes (n + 1, M) and LUTs."""
    rng = np.random.default_rng(seed)
    _, _, ids, visited = _world(Q, R, n, 4, seed=seed)
    if Q > 3:
        visited[2] = 2**32 - 1
        ids[3, ::2] = n + np.arange(ids[3, ::2].size) % 40
    codes = rng.integers(0, K, size=(n + 1, M)).astype(np.uint8)
    luts = rng.standard_normal((Q, M, K), dtype=np.float32)
    return ids, visited, codes, luts


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(8, 256), (4, 256), (16, 16), (40, 16)])
@pytest.mark.parametrize("Q,R,n", [(64, 20, 5000), (9, 37, 700), (5, 3, 70), (1, 1, 1)])
def test_cuda_adc_hop_is_bit_identical_to_the_generic_kernel(cuda, M, K, Q, R, n):
    """The ADC hop kernel (the visited word loaded with the codes, applied at
    the store) gives the generic kernel's dists and ids bit for bit, and the
    plain version's: M of 4 (byte loads), 8, 16 and 40 (8-byte loads); a
    table offset by M bytes (byte loads); Q x R past one block of 256
    pairs; an all-padding row, a row with every id visited, ids past n - 1."""
    ids, visited, codes, luts = _adc_hop_world(Q, R, n, M, K, seed=M + K + Q)
    it, vt = _c(ids, cuda, torch.int32), convert.bitmap_from_uint32(visited, cuda)
    ct = torch.from_numpy(codes).to(cuda)
    lt = _c(luts, cuda)
    for table in (ct[:n], ct[1:]):
        got_d, got_i = cuda_ga.gather_adc_masked(it, table, lt, vt)
        want_d, want_i = ref.gather_adc_masked_ref(it, table, lt, vt)
        assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
        gen_d, gen_i = cuda_ga.gather_adc_masked_generic(it, table, lt, vt)
        assert torch.equal(gen_i, got_i) and torch.equal(gen_d, got_d)
        if Q > 3:
            assert (got_i[0] == -1).all() and torch.isinf(got_d[0]).all()
            assert (got_i[2] == -1).all() and torch.isinf(got_d[2]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(8, 256), (4, 256), (16, 16), (8, 16), (16, 256)])
@pytest.mark.parametrize("Q,n", [(64, 5000), (21, 9001), (16, 64), (33, 129), (17, 1)])
def test_cuda_pq_adc_interleaved_is_bit_identical_to_the_generic_kernel(cuda, M, K, Q, n):
    """pq_adc's route: the interleaved kernel wherever scan_route sends it
    (Q past one group of 16 queries and ragged, n past one 64-row tile and
    ragged, odd n, a table offset by M bytes), the generic kernel where the
    LUTs do not fit (M=16, K=256); bit-identical to the generic kernel and
    to the plain version, and the launch counts name the kernel that ran."""
    rng = np.random.default_rng(Q + n + M)
    ct = torch.from_numpy(rng.integers(0, K, size=(n + 1, M)).astype(np.uint8)).to(cuda)
    lt = _c(rng.standard_normal((Q, M, K), dtype=np.float32), cuda)
    for table in (ct[:n], ct[1:]):
        route = cuda_pa.scan_route(Q, M, K, table.data_ptr())
        assert route == ("generic" if (M, K) == (16, 256) else "interleaved")
        ops.reset_launch_counts()
        got = ops.pq_adc(table, lt)
        counts = ops.launch_counts()
        assert (counts["pq_adc"], counts["pq_adc_generic"]) == (
            (1, 0) if route == "interleaved" else (0, 1))
        assert torch.equal(got, cuda_pa.pq_adc_generic(table, lt))
        assert torch.equal(got, ref.pq_adc_ref(table, lt))


@pytest.mark.cuda
def test_cuda_pq_adc_many_query_groups_and_rows(cuda):
    """Q past one query group and n past one row tile, ragged at both, on
    the interleaved and the generic kernel."""
    rng = np.random.default_rng(12)
    _, codes = _codes(rng, 9001, 4, 8, 256, cuda)
    luts = _c(rng.standard_normal((21, 8, 256), dtype=np.float32), cuda)
    want = ref.pq_adc_ref(codes, luts)
    assert torch.equal(cuda_pa.pq_adc(codes, luts), want)
    assert torch.equal(cuda_pa.pq_adc_generic(codes, luts), want)


@pytest.mark.cuda
def test_cuda_ops_dispatch_to_the_kernels_and_count(cuda):
    queries, base, ids, visited = _world(4, 6, 100, 8)
    qt, it, bt = _c(queries, cuda), _c(ids, cuda, torch.int32), _c(base, cuda)
    vt = convert.bitmap_from_uint32(visited, cuda)
    (codes, scale, mn), pq_codes = _codes(np.random.default_rng(1), 100, 8, 8, 16, cuda)
    luts = torch.randn((4, 8, 16), device=cuda)
    ops.reset_launch_counts()
    ops.gather_distance(qt, it, bt)
    ops.gather_distance_masked(qt, it, bt, vt)
    ops.distance_matrix(qt, bt)
    ops.gather_sq8_masked(qt, it, codes, scale, mn, vt)
    ops.gather_adc_masked(it, pq_codes, luts, vt)
    ops.pq_adc(pq_codes, luts)                    # Q = 4: the generic kernel
    ops.pq_adc(pq_codes, luts.repeat(4, 1, 1))    # Q = 16: the interleaved kernel
    q = torch.randn((1, 16, 4, 8), device=cuda)
    ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    ops.gather_distance_pool(bt, it.repeat(25, 1))
    assert ops.launch_counts() == {"gather_distance": 1, "gather_distance_generic": 0,
                                   "gather_distance_pool": 4,
                                   "gather_distance_masked": 1,
                                   "gather_distance_masked_generic": 0,
                                   "distance_matrix": 1, "distance_matrix_small": 0,
                                   "distance_matrix_tile32": 0, "gather_sq8_masked": 1,
                                   "gather_sq8_masked_generic": 0,
                                   "gather_adc_masked": 1, "gather_adc_masked_generic": 0,
                                   "pq_adc": 1, "pq_adc_generic": 1,
                                   "flash_attention": 1, "flash_attention_bwd": 0}
    with pytest.raises(ValueError, match="contiguous"):
        ops.distance_matrix(qt.t(), bt.t())
    with pytest.raises(ValueError, match="int32"):
        ops.gather_distance(qt, it.long(), bt)
    with pytest.raises(ValueError, match="uint8"):
        ops.pq_adc(pq_codes.int(), luts)


@pytest.mark.cuda
def test_cuda_adc_wrappers_reject_codes_past_the_lut(cuda):
    """The ADC kernels index the LUT by code unchecked: the wrappers raise
    on a code >= K before launching."""
    _, _, ids, visited = _world(4, 6, 100, 8)
    it, vt = _c(ids, cuda, torch.int32), convert.bitmap_from_uint32(visited, cuda)
    _, pq_codes = _codes(np.random.default_rng(2), 100, 8, 8, 16, cuda)
    pq_codes[5, 3] = 200
    luts = torch.randn((4, 8, 16), device=cuda)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="past a LUT of K=16"):
        cuda_ga.gather_adc_masked(it, pq_codes, luts, vt)
    with pytest.raises(ValueError, match="past a LUT of K=16"):
        cuda_pa.pq_adc(pq_codes, luts)
    with pytest.raises(ValueError, match="past a LUT of K=16"):
        cuda_ga.gather_adc_masked_generic(it, pq_codes, luts, vt)
    with pytest.raises(ValueError, match="past a LUT of K=16"):
        cuda_pa.pq_adc(pq_codes, luts.repeat(4, 1, 1))
    assert not any(v for k, v in ops.launch_counts().items() if "adc" in k)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_beam_search_matches_cpu(cuda, metric):
    """The beam on the card (CUDA kernels) against the same beam on the CPU
    (plain versions), from the same graph and entries: identical ids,
    n_comps and n_steps (random data at this size has no float32 near-ties
    at the list boundaries)."""
    from repro_torch.core import bruteforce, diversify
    from repro_torch.core.beam_search import dedup_rows

    rng = np.random.default_rng(8)
    base = torch.from_numpy(rng.standard_normal((2000, 16), dtype=np.float32))
    queries = torch.from_numpy(rng.standard_normal((48, 16), dtype=np.float32))
    nbrs = diversify.add_reverse_edges(bruteforce.exact_knn_graph(base, 12).neighbors, 16)
    entries = dedup_rows(torch.from_numpy(
        rng.integers(0, 2000, size=(48, 8)).astype(np.int32)))
    s_cpu = convert.searcher_from_numpy(base, nbrs, metric=metric, device="cpu")
    s_gpu = convert.searcher_from_numpy(base, nbrs, metric=metric, device=cuda)
    spec = s_cpu.spec(ef=32, k=10)
    want = s_cpu.search(queries, spec, entries=entries)
    got = s_gpu.search(queries.to(cuda), spec, entries=entries.to(cuda))
    assert torch.equal(got.ids.cpu(), want.ids)
    assert torch.equal(got.n_comps.cpu(), want.n_comps)
    assert int(got.n_steps) == int(want.n_steps)
    torch.testing.assert_close(got.dists.cpu(), want.dists, **GATHER_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("scorer", ["sq8", "pq"])
def test_cuda_compressed_beam_search_matches_cpu(cuda, scorer):
    """The compressed beam on the card against the same beam on the CPU,
    from the same graph, entries and scorer state: identical ids, n_comps,
    n_steps and bytes_touched (pq's ADC is bit-identical; sq8 has no
    float32 near-ties at the list boundaries at this size)."""
    from repro_torch.baselines.pq import build_pq
    from repro_torch.core import bruteforce, diversify
    from repro_torch.core.beam_search import beam_search, dedup_rows

    rng = np.random.default_rng(9)
    base = torch.from_numpy(rng.standard_normal((2000, 16), dtype=np.float32))
    queries = torch.from_numpy(rng.standard_normal((48, 16), dtype=np.float32))
    nbrs = diversify.add_reverse_edges(bruteforce.exact_knn_graph(base, 12).neighbors, 16)
    entries = dedup_rows(torch.from_numpy(
        rng.integers(0, 2000, size=(48, 8)).astype(np.int32)))
    s_cpu = convert.searcher_from_numpy(base, nbrs, device="cpu",
                                        pq=build_pq(base, M=8, K=64, iters=4, key=1))
    spec = s_cpu.spec(ef=32, k=10, scorer=scorer, pq_k=64, rerank=16)
    # one scorer state (the CPU's tables and LUTs) for both devices
    state = s_cpu.scorer_state(queries, spec)
    kw = dict(ef=32, k=10, scorer=scorer, rerank=16)
    want = beam_search(queries, base, nbrs, entries, scorer_state=state, **kw)
    got = beam_search(queries.to(cuda), base.to(cuda), nbrs.to(cuda), entries.to(cuda),
                      scorer_state=tuple(t.to(cuda) for t in state), **kw)
    assert torch.equal(got.ids.cpu(), want.ids)
    assert torch.equal(got.n_comps.cpu(), want.n_comps)
    assert torch.equal(got.bytes_touched.cpu(), want.bytes_touched)
    assert int(got.n_steps) == int(want.n_steps)
    torch.testing.assert_close(got.dists.cpu(), want.dists, **GATHER_TOL)


def _tier_world(cuda, n=3000, d=32, seed=12):
    """A searcher on the card over an exact 12-NN graph with reverse edges,
    a PQ table (M=8, K=64), tenant/tag/timestamp columns, and 100 queries."""
    from repro_torch.baselines.pq import build_pq
    from repro_torch.core import bruteforce, diversify

    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
    queries = torch.from_numpy(rng.standard_normal((100, d), dtype=np.float32)).to(cuda)
    nbrs = diversify.add_reverse_edges(bruteforce.exact_knn_graph(base, 12).neighbors, 16)
    metadata = {"tenant": rng.integers(0, 4, n), "tag": rng.integers(0, 16, n),
                "timestamp": rng.permutation(n)}
    s = convert.searcher_from_numpy(base, nbrs, device=cuda, metadata=metadata, rng_seed=5,
                                    pq=build_pq(base.to(cuda), M=8, K=64, iters=4, key=1))
    return s, queries


def _same_result(a, b, bytes_too=True):
    for f in ("ids", "dists", "n_comps") + (("bytes_touched",) if bytes_too else ()):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(a.n_steps) == int(b.n_steps)


@pytest.mark.cuda
@pytest.mark.parametrize("scorer", ["sq8", "pq"])
def test_cuda_tier_rerank_is_bit_identical_to_device_placement(cuda, scorer):
    """Host and disk tiers rerank their staged rows through the pair kernel
    (ops.gather_distance with the rows as the base): ids, dists, n_comps and
    n_steps bit for bit against device placement, f32 stores; the rows came
    through pinned buffers and a side-stream copy."""
    s, q = _tier_world(cuda)
    spec = s.spec(ef=48, k=10, scorer=scorer, pq_k=64)
    ops.reset_launch_counts()
    dev = s.search(q, spec, 3)
    host = s.search(q, spec._replace(base_placement="host"), 3)
    disk = s.search(q, spec._replace(base_placement="disk"), 3)
    _same_result(dev, host)
    _same_result(dev, disk, bytes_too=False)
    assert ops.launch_counts()["gather_distance"] == 3      # one rerank per placement
    assert s.base_store("host").gathered_rows == 100 * 48


@pytest.mark.cuda
def test_cuda_staged_rows_rerank_equals_the_base_gather(cuda):
    """rerank_gathered over rows staged from the host equals
    ops.gather_distance over the device base, bit for bit, INVALIDs
    included."""
    from repro_torch.core.base_store import BaseStore, rerank_gathered
    from repro_torch.core.topk import topk_smallest

    s, q = _tier_world(cuda)
    rng = np.random.default_rng(3)
    cand = torch.from_numpy(rng.integers(-1, s.base.shape[0], (100, 64)).astype(np.int32)).to(cuda)
    for dtype in ("f32", "bf16"):
        store = BaseStore(s.base, "host", dtype=dtype)
        rows, nbytes = store.gather(cand)
        assert rows.device == s.device
        assert int(nbytes.sum()) == int((cand >= 0).sum()) * store.row_bytes
        dd, ids = rerank_gathered(q, cand, rows, k=10)
        base = s.base if dtype == "f32" else s.base.to(torch.bfloat16).float()
        want_d, sel = topk_smallest(ops.gather_distance(q, cand, base.contiguous()), 10)
        assert torch.equal(dd, want_d) and torch.equal(ids, cand.gather(1, sel))


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["host", "disk"])
def test_cuda_stream_pipeline_equals_per_tile_search(cuda, placement):
    """search_stream copies tile i's rows while tile i+1 traverses: every
    tile equals its own direct search, bit for bit (no staging buffer
    overwritten in flight)."""
    from repro_torch.core.engine import _fold

    s, q = _tier_world(cuda)
    spec = s.spec(ef=48, k=10, scorer="pq", pq_k=64, base_placement=placement)
    stream = s.search_stream(q, spec, 9, tile_q=16)
    for i, lo in enumerate(range(0, 100, 16)):
        tile = q[lo:lo + 16]
        valid = torch.arange(16, device=cuda) < tile.shape[0]
        padded = torch.cat([tile, tile.new_zeros((16 - tile.shape[0], tile.shape[1]))])
        want = s.search(padded, spec, _fold(9, i), q_valid=valid)
        take = tile.shape[0]
        assert torch.equal(stream.ids[lo:lo + take], want.ids[:take])
        assert torch.equal(stream.dists[lo:lo + take], want.dists[:take])


@pytest.mark.cuda
def test_cuda_filtered_search_stays_in_the_allowed_set(cuda):
    from repro_torch.core.filters import FilterSpec

    s, q = _tier_world(cuda)
    for f in (FilterSpec(tenant=1), FilterSpec(tags_any=(2, 5)),
              FilterSpec(time_range=(0, 150))):
        cf = s.compiled_filter(f)
        allowed = set(cf.allowed_ids[:cf.n_allowed].tolist())
        for kw in (dict(), dict(scorer="pq", pq_k=64),
                   dict(scorer="pq", pq_k=64, base_placement="disk")):
            res = s.search(q, s.spec(ef=48, k=10, filter=f, **kw), 4)
            ids = res.ids[res.ids >= 0].tolist()
            assert ids and all(i in allowed for i in ids)


@pytest.mark.cuda
def test_cuda_saved_index_reloads_on_the_card(cuda, tmp_path):
    from repro_torch.core import io as index_io

    s, q = _tier_world(cuda)
    spec = s.spec(ef=48, k=10, scorer="pq", pq_k=64)
    want = s.search(q, spec, 2)
    path = index_io.save_index(str(tmp_path / "idx"), index_io.IndexArtifact.from_searcher(s),
                               shard_rows=1000)
    got = index_io.load_index(path).to_searcher(cuda)
    assert got.device.type == "cuda" and got.pq.codes.is_cuda
    _same_result(want, got.search(q, spec, 2))


@pytest.mark.cuda
def test_cuda_pq_training_is_deterministic(cuda):
    """Same-seed PQ training on the card gives identical codebooks and
    codes: cluster sums are one-hot matmuls, never float atomics (two row
    chunks here)."""
    from repro_torch.baselines.pq import CHUNK, build_pq

    g = torch.Generator().manual_seed(3)
    base = torch.randn((CHUNK + 4000, 16), generator=g).to(cuda)
    a = build_pq(base, M=4, K=256, iters=4, key=5)
    b = build_pq(base, M=4, K=256, iters=4, key=5)
    assert torch.equal(a.codebooks, b.codebooks) and torch.equal(a.codes, b.codes)


# fp32: the reference's own kernel tolerance; bf16: one bf16 ulp (<= 2^-7
# relative) of a cast from fp32 values that agree to ~1e-6
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=1e-5)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40), (False, None),
                                           (False, 30), (True, 128)])
@pytest.mark.parametrize("B,S,Hq,Hkv,dh,dhv", [(2, 256, 8, 8, 64, 64),
                                               (1, 300, 8, 1, 128, 128),
                                               (2, 200, 32, 8, 80, 80),
                                               (1, 70, 4, 2, 128, 24),
                                               (2, 300, 8, 2, 40, 40),
                                               (2, 127, 4, 2, 64, 64),
                                               (2, 128, 4, 2, 64, 64),
                                               (2, 129, 4, 2, 64, 64),
                                               (1, 1, 1, 1, 64, 64),
                                               (2, 200, 8, 2, 256, 256),
                                               (1, 129, 4, 4, 192, 128),
                                               (1, 65, 4, 2, 200, 160)])
def test_cuda_flash_attention_matches_plain(cuda, dtype, causal, window, B, S, Hq, Hkv,
                                            dh, dhv):
    """Windows (128: on the bf16 kernel's key-tile edge), GQA ratios 1 to 8,
    dh 40 / 64 / 80 / 128 (40 is no multiple of 16), dhv != dh, ragged tails
    and S = 127 / 128 / 129 around the bf16 kernel's 128-row tile, S = 1;
    past 128 (64-key stages): Gemma3's 256, DeepSeek's 192 / 128, 200 / 160."""
    g = torch.Generator(device=cuda).manual_seed(S + Hq + dh)
    q = torch.randn((B, S, Hq, dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, S, Hkv, dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, S, Hkv, dhv), generator=g, device=cuda).to(dtype)
    got = cuda_fa.flash_attention(q, k, v, causal, window)
    want = ref.flash_attention_ref(q, k, v, causal, window)
    assert got.dtype == dtype and got.shape == (B, S, Hq, dhv)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.cuda
def test_cuda_flash_attention_bf16_runs_the_tensor_core_kernel(cuda):
    """A bf16 call at TinyLlama's head layout (32/4, dh=64) launches the
    wgmma kernel once and the fp32 FMA kernel never, by symbol under the
    profiler; an fp32 call the other way round."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(5)
    for dtype, runs, never in ((torch.bfloat16, "flash_attention_wgmma_kernel",
                                "flash_attention_kernel"),
                               (torch.float32, "flash_attention_kernel",
                                "flash_attention_wgmma_kernel")):
        q = torch.randn((1, 256, 32, 64), generator=g, device=cuda).to(dtype)
        kv = torch.randn((1, 256, 4, 64), generator=g, device=cuda).to(dtype)
        cuda_fa.flash_attention(q, kv, kv)
        marker = torch.zeros(1, device=cuda)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # the profiler may leave a window's first kernel out: a fill
            # takes that place
            marker.fill_(1.0)
            torch.cuda.synchronize()
            cuda_fa.flash_attention(q, kv, kv)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and runs in e.key) == 1, names
        assert not any(never + "<" in n for n in names), names


@pytest.mark.cuda
def test_cuda_flash_attention_reads_strided_layouts(cuda):
    """q, k and v as views of one fused (B, S, H, 3 dh) projection, and a
    given softmax scale: the kernel reads through the strides."""
    qkv = torch.randn((2, 130, 4, 3 * 32), device=cuda)
    q, k, v = qkv[..., :32], qkv[..., 32:64], qkv[..., 64:]
    assert not q.is_contiguous()
    got = cuda_fa.flash_attention(q, k, v, softmax_scale=0.3)
    want = ref.flash_attention_ref(q, k, v, softmax_scale=0.3)
    torch.testing.assert_close(got, want, **FLASH_TOL[torch.float32])


@pytest.mark.cuda
def test_cuda_flash_attention_bf16_layouts(cuda):
    """bf16: views of a fused projection are read in place by TMA; a
    (B, H, S, d) tensor seen as (B, S, H, d), a row of 20 bf16 (40 bytes)
    and a base 2 bytes off alignment are copied first. All match the plain
    version."""
    bf16 = torch.bfloat16
    qkv = torch.randn((2, 130, 4, 3 * 32), device=cuda).to(bf16)
    flat = torch.randn((2 * 130 * 4 * 32 + 1,), device=cuda).to(bf16)
    layouts = [
        (qkv[..., :32], qkv[..., 32:64], qkv[..., 64:]),
        tuple(torch.randn((2, 4, 130, 32), device=cuda).to(bf16).transpose(1, 2)
              for _ in range(3)),
        tuple(torch.randn((2, 130, 4, 20), device=cuda).to(bf16) for _ in range(3)),
        (flat[1:].view(2, 130, 4, 32),) * 3,
    ]
    for q, k, v in layouts:
        got = cuda_fa.flash_attention(q, k, v, softmax_scale=0.3)
        want = ref.flash_attention_ref(q, k, v, softmax_scale=0.3)
        torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[bf16])


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_what_it_does_not_take(cuda):
    q = torch.randn((1, 8, 2, 16), device=cuda)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="head dims"):
        cuda_fa.flash_attention(*(torch.randn((1, 8, 2, 257), device=cuda),) * 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_fa.flash_attention(q.cpu(), q.cpu(), q.cpu())
    with pytest.raises(ValueError, match="share a dtype"):
        cuda_fa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="unsupported dtype"):
        cuda_fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="window"):
        cuda_fa.flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        cuda_fa.flash_attention(torch.randn((1, 8, 3, 16), device=cuda), q, q)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fa.flash_attention(q, q, q.transpose(2, 3).contiguous().transpose(2, 3))
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ["tinyllama-1.1b", "h2o-danube-1.8b", "deepseek-v3-671b"])
def test_cuda_lm_matches_cpu(cuda, arch_id):
    """The smoke LM on the card (flash kernel in prefill) against the same
    weights on the CPU (plain attention): fp32 prefill logits within 1e-4
    and the same greedy decode stream past Danube smoke's window. DeepSeek's
    smoke runs its dense prefix and MLA layers (flash at dh = 24, dhv = 16
    in prefill, the absorbed decode) and carries its MTP weights unrun."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    cfg = configs.get_arch(arch_id).smoke_cfg
    cpu_model = tf.init_params(cfg, seed=1, device="cpu")
    gpu_model = tf.init_params(cfg, seed=1, device="cpu").to(cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (4, 96)))
    ops.reset_launch_counts()
    got = tf.prefill(gpu_model, toks.to(cuda))
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), tf.prefill(cpu_model, toks), rtol=1e-4, atol=1e-4)
    a = serve.serve_lm(cpu_model, batch=3, tokens=20, max_len=32)
    b = serve.serve_lm(gpu_model, batch=3, tokens=20, max_len=32)
    assert torch.equal(a.tokens, b.tokens.cpu())


# -- streaming mutation (core.mutable) on the card ------------------------------


def _mutable_world(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d), dtype=np.float32),
            rng.standard_normal((64, d), dtype=np.float32))


@pytest.mark.cuda
def test_cuda_exact_scan_has_the_batch_matrix_bits(cuda):
    """The exact scan's block, in both directions, gives the batch distance
    matrix's row and column of the point bit for bit, and so does a one-row
    operand: the kernel's entries do not depend on the operand's shape."""
    from repro_torch.core import mutable

    base, _ = _mutable_world(3000, 64)
    bt = _c(base, cuda)
    alive = torch.ones(3000, dtype=torch.bool, device=cuda)
    batch = ops.distance_matrix(bt, bt)
    for i in (0, 17, 2999):
        fwd, rev = mutable._exact_scan(bt[i], bt, alive, "l2")
        assert torch.equal(fwd, batch[i]) and torch.equal(rev, batch[:, i])
        assert torch.equal(ops.distance_matrix(bt[i:i + 1], bt)[0], fwd)
        assert torch.equal(ops.distance_matrix(bt, bt[i:i + 1])[:, 0], rev)


@pytest.mark.cuda
def test_cuda_incremental_exact_equals_the_exact_build(cuda):
    """construct="incremental", insert_ef=0 equals construct="exact" bit for
    bit on the card (the tile route, n past 32)."""
    from repro_torch.core.build import BuildSpec, build_index

    base, _ = _mutable_world(1500, 32, seed=1)
    kw = dict(diversify="none", graph_k=12, proxy_sample=0, lid_sample=0)
    bt = _c(base, cuda)
    inc = build_index(bt, BuildSpec(construct="incremental", insert_ef=0, **kw), seed=2)
    bat = build_index(bt, BuildSpec(construct="exact", **kw), seed=2)
    assert torch.equal(inc.graph.neighbors, bat.graph.neighbors)
    assert torch.equal(inc.graph.dists, bat.graph.dists)
    assert inc.report.inserts == 1500


@pytest.fixture(scope="module")
def mutated_on_card():
    """NN-Descent + GD over 3,000 points on the card, 60 inserts at
    insert_ef=32 with GD inline, 20% of the original ids deleted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from repro_torch.core.build import BuildSpec, build_index
    from repro_torch.core.mutable import MutableIndex

    dev = torch.device("cuda")
    base, queries = _mutable_world(3000, 32, seed=3)
    spec = BuildSpec(graph_k=12, nd_rounds=8, proxy_sample=0, lid_sample=0)
    midx = MutableIndex.from_build(_c(base, dev), build_index(_c(base, dev), spec, seed=4),
                                   rng_seed=4, insert_ef=32, diversify="gd")
    extra = np.random.default_rng(5).standard_normal((60, 32), dtype=np.float32)
    new_ids = midx.insert_batch(extra)
    dead = np.random.default_rng(6).choice(3000, size=600, replace=False)
    midx.delete(dead)
    return midx, spec, dead, new_ids, queries


@pytest.mark.cuda
@pytest.mark.parametrize("scorer,placement", [("exact", "device"), ("pq", "device"),
                                              ("pq", "host"), ("pq", "disk"),
                                              ("sq8", "disk")])
def test_cuda_tombstones_never_answer(mutated_on_card, scorer, placement):
    from repro_torch.core.engine import SearchSpec

    midx, _, dead, _, queries = mutated_on_card
    s = midx.searcher()
    spec = SearchSpec(ef=48, k=8, scorer=scorer, base_placement=placement, pq_m=4, pq_k=16)
    try:
        ids = s.search(_c(queries, s.device), spec, seed=7).ids.cpu().numpy()
    finally:
        for store in s._stores.values():
            store.close()
        s._stores.clear()
    assert (ids >= 0).any() and not np.isin(ids[ids >= 0], dead).any()
    assert ids.max() < midx.n_alloc


@pytest.mark.cuda
def test_cuda_compact_equals_a_fresh_build(mutated_on_card):
    """compact(spec, seed) on the card equals build_index of the survivors
    with the same spec and seed, bit for bit; the inserted points were
    searchable before it."""
    from repro_torch.core.build import build_index
    from repro_torch.core.engine import SearchSpec

    midx, spec, _, new_ids, _ = mutated_on_card
    x = torch.from_numpy(midx.base[new_ids[:16]].copy()).cuda()
    found = midx.search(x, SearchSpec(ef=64, k=1), seed=8).ids[:, 0].cpu().numpy()
    assert (found == new_ids[:16]).mean() >= 0.75
    survivors = midx.base[midx.alive].copy()
    cres = midx.compact(spec, seed=9)
    fresh = build_index(torch.from_numpy(survivors).cuda(), spec, seed=9)
    assert torch.equal(cres.graph.neighbors, fresh.graph.neighbors)
    assert np.array_equal(midx.base, survivors) and midx.version == 1


# -- the continuous-batching server and the snapshot Searcher ----------------------


@pytest.fixture(scope="module")
def served_on_card():
    """A 3,000 x 64 normal world built on the card (NN-Descent + GD), 32
    queries; module-scoped, so it skips in the tests that take it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from repro_torch.core.engine import Searcher

    rng = np.random.default_rng(23)
    base = rng.standard_normal((3000, 64), dtype=np.float32)
    queries = rng.standard_normal((32, 64), dtype=np.float32)
    return Searcher.build(torch.from_numpy(base).cuda(), seed=23), queries


@pytest.mark.cuda
@pytest.mark.parametrize("scorer", ["exact", "pq", "sq8"])
@pytest.mark.parametrize("qn,bucket", [(1, 2), (3, 4), (11, 16), (16, 16)])
def test_cuda_padded_bucket_equals_direct_search(served_on_card, scorer, qn, bucket):
    """The server's padded bucket against a direct search of the real rows
    with the same seed: ids, dists and n_comps bit for bit, pad rows empty."""
    from repro_torch.launch.server import AnnServer, ServeConfig

    s, queries = served_on_card
    spec = s.spec(ef=32, k=4, scorer=scorer)
    srv = AnnServer(s, spec, ServeConfig(buckets=(bucket,)))
    rows = queries[:qn]
    direct = s.search(torch.from_numpy(rows).cuda(), spec, 123)
    padded = srv._search_padded(rows, 123, bucket)
    for f in ("ids", "dists", "n_comps"):
        assert torch.equal(getattr(padded, f)[:qn], getattr(direct, f)), f
    assert (padded.n_comps[qn:] == 0).all() and (padded.ids[qn:] == -1).all()


@pytest.mark.cuda
def test_cuda_ready_follows_the_event(served_on_card):
    """``_ready`` is False while the batch's event is pending on the stream
    and True once it has completed; ``_retire`` waits for it."""
    from repro_torch.launch.server import AnnServer, ServeConfig, _LiveBatch

    s, queries = served_on_card
    srv = AnnServer(s, s.spec(ef=32, k=4), ServeConfig(buckets=(4,)))
    req = srv.submit(queries[:3], 5, advance=False)
    res = srv._search_padded(req.queries, req.seed, req.bucket)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)          # ~0.1 s of GPU cycles ahead of the event
    ev = torch.cuda.Event()
    ev.record()
    lb = _LiveBatch(req, res, ev)
    assert not srv._ready(lb)
    torch.cuda.synchronize()
    assert srv._ready(lb)
    req.t_admit = req.t_dispatch = req.t_enqueue
    srv._retire(lb)
    assert req.ids.shape == (3, 4) and req.t_complete >= req.t_enqueue


@pytest.mark.cuda
def test_cuda_searcher_is_a_snapshot(served_on_card):
    """A MutableIndex Searcher on the card answers bit for bit as before
    after inserts and deletes written into the mirrors in place (capacity
    large enough that no growth replaces them)."""
    from repro_torch.core.mutable import MutableIndex

    s, queries = served_on_card
    midx = MutableIndex(s.base, s.neighbors, capacity=4096, insert_ef=32, diversify="gd",
                        device="cuda")
    snap = midx.searcher()
    spec = snap.spec(ef=32, k=4)
    q = torch.from_numpy(queries).cuda()
    before = snap.search(q, spec, 5)
    extra = np.random.default_rng(24).standard_normal((200, 64), dtype=np.float32)
    midx.insert_batch(extra)
    top1 = np.unique(before.ids[:, 0].cpu().numpy())
    midx.delete(top1[top1 >= 0])
    after = snap.search(q, spec, 5)
    for f in ("ids", "dists", "n_comps", "n_steps"):
        assert torch.equal(getattr(after, f), getattr(before, f)), f
    assert midx.cow_clones == 3
    fresh = midx.searcher().search(q, spec, 5).ids.cpu().numpy()
    assert not np.isin(fresh, top1[top1 >= 0]).any()


@pytest.fixture(scope="module")
def nccl_shard_world():
    """A one-rank NCCL flat group and one shard on the card: n=4,000, d=16
    normal rows, the exact construct + GD + pq (M=8, K=64), 50 queries and
    their (1, Q, 8) entries. The group goes with the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL and the CUDA kernels have no CPU mode)")
    import torch.distributed as dist
    from repro_torch.core.build import BuildSpec
    from repro_torch.core.engine import shard_entries
    from repro_torch.distributed.sharded_ann import shard_build
    from repro_torch.launch.mesh import make_flat_group

    rng = np.random.default_rng(24)
    base = torch.from_numpy(rng.standard_normal((4000, 16), dtype=np.float32)).cuda()
    queries = torch.from_numpy(rng.standard_normal((50, 16), dtype=np.float32)).cuda()
    sb = shard_build(base, 1, spec=BuildSpec(construct="exact", diversify="gd", graph_k=12,
                                             compress="pq", pq_m=8, pq_k=64, pq_iters=5,
                                             proxy_sample=0, lid_sample=0), seed=0)
    ent = shard_entries(torch.Generator(device="cuda").manual_seed(3), 1, 50, 4000, 8)
    created = not dist.is_initialized()
    fg = make_flat_group("cuda")
    yield fg, sb, queries, ent
    if created:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("scorer", ["exact", "pq"])
def test_cuda_one_rank_nccl_search_matches_emulated_and_searcher(nccl_shard_world, scorer):
    """distributed_search on one NCCL rank: bit for bit the emulated loop
    over the same shard and a Searcher over it, on the same entries."""
    import torch.distributed as dist
    from repro_torch.baselines.pq import PQIndex
    from repro_torch.core.engine import Searcher, SearchSpec, emulated_shard_search
    from repro_torch.distributed.sharded_ann import distributed_search, pq_shard_state

    fg, sb, q, ent = nccl_shard_world
    assert dist.get_backend(fg.group) == "nccl" and fg.size == 1
    spec = SearchSpec(ef=48, k=4, scorer=scorer)
    live = torch.ones((1,), dtype=torch.bool, device="cuda")
    kw = dict(ef=48, k=4, group=fg.group, scorer=scorer)
    states = None
    if scorer == "pq":
        kw.update(pq_codebooks=sb.pq_codebooks, pq_codes=sb.pq_codes)
        states = [pq_shard_state(q, sb.pq_codebooks[0], sb.pq_codes[0], "l2")]
    d, i, c = distributed_search(q, sb.base_shards, sb.nbr_shards, ent, live, **kw)
    ed, ei, ec = emulated_shard_search(q, sb.base_shards, sb.nbr_shards, ent, live, spec,
                                       scorer_states=states)
    assert torch.equal(i, ei) and torch.equal(d, ed) and torch.equal(c, ec)
    pq = PQIndex(codebooks=sb.pq_codebooks[0], codes=sb.pq_codes[0], M=8, K=64)
    s = Searcher(sb.base_shards[0], sb.nbr_shards[0], pq=pq)
    want = s.search(q, s.spec(ef=48, k=4, scorer=scorer, pq_k=64), entries=ent[0])
    assert torch.equal(i, want.ids) and torch.equal(d, want.dists)
    assert torch.equal(c, want.n_comps)


@pytest.mark.cuda
def test_cuda_one_rank_nccl_host_tiers_match_device_pq(nccl_shard_world):
    from repro_torch.core.base_store import BaseStore
    from repro_torch.distributed.sharded_ann import distributed_search

    fg, sb, q, ent = nccl_shard_world
    live = torch.ones((1,), dtype=torch.bool, device="cuda")
    kw = dict(ef=48, k=4, group=fg.group, scorer="pq", pq_codebooks=sb.pq_codebooks,
              pq_codes=sb.pq_codes)
    d, i, c = distributed_search(q, sb.base_shards, sb.nbr_shards, ent, live, **kw)
    for placement in ("host", "disk"):
        store = BaseStore(sb.base_shards[0], placement, device="cuda")
        hd, hi, hc = distributed_search(q, None, sb.nbr_shards, ent, live,
                                        base_placement=placement, host_base=store, **kw)
        assert torch.equal(hi, i) and torch.equal(hd, d), placement
        assert (hc - c).abs().max() <= 1, placement
        store.close()


# -- the attention backward and LM training ---------------------------------------

# (B, S, Hq, Hkv, dh, dhv, causal, window, scale)
BWD_CASES = [(2, 100, 8, 2, 64, 64, True, None, None), (1, 77, 4, 4, 128, 128, True, 20, 0.2),
             (1, 65, 4, 2, 256, 256, True, None, None), (1, 70, 4, 4, 192, 128, True, None, None),
             (2, 33, 8, 1, 16, 16, False, 5, None), (1, 1, 1, 1, 64, 64, True, None, None),
             (1, 90, 4, 2, 40, 36, True, None, None)]


def _bwd_inputs(cuda, case, dtype):
    B, S, Hq, Hkv, dh, dhv, causal, window, scale = case
    g = torch.Generator(device=cuda).manual_seed(S + dh)
    return tuple(torch.randn(shape, generator=g, device=cuda).to(dtype)
                 for shape in ((B, S, Hq, dh), (B, S, Hkv, dh), (B, S, Hkv, dhv),
                               (B, S, Hq, dhv)))


def _assert_within_bwd_tol(got, want, dtype):
    """|kernel - plain| <= rtol |plain| + atol m, m the largest max-abs of
    the call's plain dq, dk and dv (chip_smoke.py's BWD_TOL)."""
    rtol, atol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 1e-3)
    m = max(float(w.float().abs().max()) for w in want)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        excess = (a.float() - b.float()).abs() - rtol * b.float().abs() - atol * m
        assert float(excess.max()) <= 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c[:8])))
def test_cuda_flash_attention_bwd_matches_plain(cuda, case, dtype):
    """The backward's routes against the plain version within BWD_TOL: bf16
    on the tensor cores from the forward's lse, fp32 on the FMA pair (both
    sum the same terms in another order, the tensor-core route with P and
    dS as bf16 hi + lo; bf16 also rounds the result)."""
    _, _, _, _, _, _, causal, window, scale = case
    q, k, v, dout = _bwd_inputs(cuda, case, dtype)
    if dtype == torch.bfloat16:
        out, lse = cuda_fa.flash_attention(q, k, v, causal, window, scale, return_lse=True)
    else:
        out, lse = cuda_fa.flash_attention(q, k, v, causal, window, scale), None
    got = cuda_fa.flash_attention_bwd(q, k, v, out, dout, causal, window, scale, lse=lse)
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, causal, window, scale)
    _assert_within_bwd_tol(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c[:8])))
def test_cuda_flash_attention_bwd_fma_yardstick_matches_plain(cuda, case, dtype):
    """The first backward's FMA pair (the fp32 route and the bf16 route's yardstick)
    within BWD_TOL in both dtypes."""
    _, _, _, _, _, _, causal, window, scale = case
    q, k, v, dout = _bwd_inputs(cuda, case, dtype)
    out = cuda_fa.flash_attention(q, k, v, causal, window, scale)
    got = cuda_fa.flash_attention_bwd_fma(q, k, v, out, dout, causal, window, scale)
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, causal, window, scale)
    _assert_within_bwd_tol(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c[:8])))
def test_cuda_flash_attention_bwd_tensor_core_route_is_deterministic(cuda, case):
    """Two bf16 backward calls on the same inputs give the same bits (no
    atomics: each output element is summed by one block in a fixed order)."""
    _, _, _, _, _, _, causal, window, scale = case
    q, k, v, dout = _bwd_inputs(cuda, case, torch.bfloat16)
    out, lse = cuda_fa.flash_attention(q, k, v, causal, window, scale, return_lse=True)
    first = cuda_fa.flash_attention_bwd(q, k, v, out, dout, causal, window, scale, lse=lse)
    again = cuda_fa.flash_attention_bwd(q, k, v, out, dout, causal, window, scale, lse=lse)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c[:8])))
def test_cuda_flash_attention_lse_keeps_the_output_bits(cuda, case):
    """The bf16 forward asked for its log-sum-exp gives the same output bits
    as without, and an lse within 1e-5 of the plain one (log2 unit)."""
    _, _, _, _, _, _, causal, window, scale = case
    q, k, v, _ = _bwd_inputs(cuda, case, torch.bfloat16)
    out = cuda_fa.flash_attention(q, k, v, causal, window, scale)
    out2, lse = cuda_fa.flash_attention(q, k, v, causal, window, scale, return_lse=True)
    _, want = ref.flash_attention_ref(q, k, v, causal, window, scale, return_lse=True)
    assert torch.equal(out, out2)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert float((lse - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_routes_by_dtype(cuda):
    """bf16 runs the three tensor-core kernels and the FMA pair never, by
    symbol under the profiler over three calls (the profiler has been seen
    to leave a window's first kernels out); fp32 the other way round; the
    fp32 forward refuses return_lse and bf16 refuses a missing lse."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(6)
    tc = ("flash_bwd_preprocess_kernel", "flash_bwd_dq_wgmma_kernel",
          "flash_bwd_dkdv_wgmma_kernel")
    fma = ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")
    for dtype, runs, never in ((torch.bfloat16, tc, fma), (torch.float32, fma, tc)):
        q, dout = (torch.randn((1, 256, 32, 64), generator=g, device=cuda).to(dtype)
                   for _ in range(2))
        kv = torch.randn((1, 256, 4, 64), generator=g, device=cuda).to(dtype)
        if dtype == torch.bfloat16:
            out, lse = cuda_fa.flash_attention(q, kv, kv, return_lse=True)
        else:
            out, lse = cuda_fa.flash_attention(q, kv, kv), None
        cuda_fa.flash_attention_bwd(q, kv, kv, out, dout, lse=lse)
        marker = torch.zeros(1, device=cuda)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marker.fill_(1.0)
            torch.cuda.synchronize()
            for _ in range(3):
                cuda_fa.flash_attention_bwd(q, kv, kv, out, dout, lse=lse)
            torch.cuda.synchronize()
        on_card = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        names = [e.key for e in on_card]
        for name in runs:   # every kernel of the file is a template: name<...>
            assert 2 <= sum(e.count for e in on_card if name + "<" in e.key) <= 3, (name,
                                                                                     names)
        assert not any(name + "<" in n for n in names for name in never), names
    q = torch.randn((1, 16, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="return_lse"):
        cuda_fa.flash_attention(q, q, q, return_lse=True)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="lse"):
        cuda_fa.flash_attention_bwd(qb, qb, qb, qb, qb)


@pytest.mark.cuda
def test_cuda_autograd_runs_the_backward_kernel_never_the_plain_version(cuda, monkeypatch):
    def no_plain(*args, **kwargs):
        raise AssertionError("the plain backward ran on CUDA tensors")

    monkeypatch.setattr(ref, "flash_attention_bwd_ref", no_plain)
    monkeypatch.setattr(ref, "flash_attention_ref", no_plain)
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda, requires_grad=True)
               for shape in ((2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32)))
    before = ops.launch_counts()
    out = ops.flash_attention(q, k, v, window=16)
    out.backward(torch.ones_like(out))
    after = ops.launch_counts()
    assert after["flash_attention"] - before["flash_attention"] == 1
    assert after["flash_attention_bwd"] - before["flash_attention_bwd"] == 1
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in (q, k, v))
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention_bwd"] == after["flash_attention_bwd"]


@pytest.mark.cuda
def test_cuda_autograd_bf16_saves_the_lse_for_the_tensor_core_backward(cuda, monkeypatch):
    """bf16 through ops.flash_attention: the forward saves its lse and the
    backward passes it to the tensor-core route (one launch each way, no
    plain call), the gradients within BWD_TOL of the plain backward."""
    seen = []
    wgmma_bwd = cuda_fa.flash_attention_bwd

    def recorded(*args, **kwargs):
        seen.append(args[-1] if len(args) == 9 else kwargs.get("lse"))
        return wgmma_bwd(*args, **kwargs)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, dout = (torch.randn(shape, generator=g, device=cuda).bfloat16()
                     for shape in ((2, 96, 8, 64), (2, 96, 2, 64), (2, 96, 2, 64),
                                   (2, 96, 8, 64)))
    want = ref.flash_attention_bwd_ref(q, k, v, cuda_fa.flash_attention(q, k, v), dout)
    monkeypatch.setattr(cuda_fa, "flash_attention_bwd", recorded)
    monkeypatch.setattr(ref, "flash_attention_bwd_ref", no_plain)
    monkeypatch.setattr(ref, "flash_attention_ref", no_plain)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = ops.launch_counts()
    ops.flash_attention(*leaves).backward(dout)
    after = ops.launch_counts()
    assert after["flash_attention"] - before["flash_attention"] == 1
    assert after["flash_attention_bwd"] - before["flash_attention_bwd"] == 1
    assert len(seen) == 1 and seen[0] is not None and seen[0].shape == (2, 8, 96)
    _assert_within_bwd_tol([t.grad for t in leaves], want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ["tinyllama-1.1b", "deepseek-v3-671b"])
def test_cuda_train_step_matches_cpu(cuda, arch_id):
    """A smoke config in fp32 from the same weights and batches on the card
    and on the CPU: the first step's loss within 1e-5 relative and every
    gradient within 1e-4 of its max-abs (fp32 sums in another order); then
    one step of the arch's optimizer on each, and the next loss within 1e-5
    relative."""
    from repro_torch import configs
    from repro_torch.data.synthetic import lm_batch_for_step
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_loop import make_train_step, trainable

    torch.backends.cuda.matmul.allow_tf32 = False
    ad = configs.get_arch(arch_id)
    cpu_model = T.init_params(ad.smoke_cfg, 0, "cpu")
    card_model = T.Transformer(ad.smoke_cfg, cuda)
    with torch.no_grad():
        for (_, a), (_, c) in zip(cpu_model.named_parameters(), card_model.named_parameters()):
            c.copy_(a)
    losses, grads = [], []
    for lm, dev in ((cpu_model, "cpu"), (card_model, cuda)):
        named = trainable(lm)
        loss, _ = T.loss_fn(lm, lm_batch_for_step(0, 0, 2, 64, ad.smoke_cfg.vocab, dev))
        grads.append([g.cpu() for g in torch.autograd.grad(loss, list(named.values()))])
        init, update = make_optimizer(ad.optimizer)
        step = make_train_step(T.loss_fn, update)
        state = init(named)
        for i in range(2):
            _, state, m = step(lm, state, lm_batch_for_step(0, i, 2, 64, ad.smoke_cfg.vocab,
                                                            dev))
            losses.append(float(m["loss"]))
    assert abs(losses[2] - losses[0]) <= 1e-5 * abs(losses[0])
    assert abs(losses[3] - losses[1]) <= 1e-5 * abs(losses[1])
    for (n, _), a, c in zip(cpu_model.named_parameters(), *grads):
        assert float((c - a).abs().max()) <= 1e-4 * max(float(a.abs().max()), 1e-30), n


# -- recsys and GNN (models/recsys.py, models/gnn.py) on the card -----------------


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ["dlrm-mlperf", "deepfm", "autoint", "bert4rec",
                                     "graphsage-reddit"])
def test_cuda_recsys_gnn_smoke_matches_cpu(cuda, arch_id):
    """A recsys or GNN smoke model from the same weights and inputs on the
    card and on the CPU, fp32 with TF32 off: every output within rtol 1e-4,
    atol 1e-5 (sums in another order; GraphSAGE's full-graph aggregate also
    sums through index_add_'s float atomics on the card). GraphSAGE: the
    full-graph, minibatch (the same draws) and dense forwards."""
    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.models import gnn, recsys

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_arch(arch_id).smoke_cfg
    gen = torch.Generator().manual_seed(3)
    if arch_id == "graphsage-reddit":
        cpu_model = gnn.init_params(cfg, 0, "cpu")
        g = synthetic.sbm_graph(gen, 500, cfg.n_classes, cfg.d_in, avg_deg=6)
        indptr, indices = synthetic.edges_to_csr(g["edges"], 500)
        nodes = torch.randint(0, 500, (64,), generator=gen)
        draws = [gnn.neighbor_draws(gen, 64, cfg.fanouts[0]),
                 gnn.neighbor_draws(gen, 64 * cfg.fanouts[0], cfg.fanouts[1])]
        feats = torch.randn((16, 30, cfg.d_in), generator=gen)
        adj = (torch.rand((16, 30, 30), generator=gen) < 0.2).float()

        def run(m, dev):
            return [gnn.forward_full(m, g["feats"].to(dev), g["edges"].to(dev)),
                    gnn.forward_minibatch(m, g["feats"].to(dev), indptr.to(dev),
                                          indices.to(dev), nodes.to(dev),
                                          draws=[d.to(dev) for d in draws]),
                    gnn.forward_dense(m, feats.to(dev), adj.to(dev))]
    elif arch_id == "bert4rec":
        cpu_model = recsys.init_params(cfg, 0, "cpu")
        items = synthetic.bert4rec_batch(gen, 32, cfg.seq_len, cfg.n_items,
                                         cfg.mask_token)["items"]
        items[0, -4:] = cfg.pad_token

        def run(m, dev):
            return [m(items.to(dev)), recsys.next_item_scores(m, items.to(dev))]
    else:
        cpu_model = recsys.init_params(cfg, 0, "cpu")
        b = synthetic.recsys_batch(gen, 256, cfg.vocab_sizes, getattr(cfg, "n_dense", 0))

        def run(m, dev):
            args = ([b["dense"].to(dev)] if "dense" in b else []) + [b["sparse"].to(dev)]
            return [m(*args)]
    card_model = copy.deepcopy(cpu_model).to(cuda)
    with torch.inference_mode():
        want, got = run(cpu_model, "cpu"), run(card_model, cuda)
    for w, c in zip(want, got):
        torch.testing.assert_close(c.cpu(), w, rtol=1e-4, atol=1e-5)


# -- recsys and GNN training, the retrieval example (chip_smoke.py phase 15) -------


def _repo_module(name: str, rel: str):
    """A script of the repository (``chip_smoke.py``, an example) as a module."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent.parent / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PHASE15_CASES = (("dlrm-sparse", "dlrm-mlperf", "train_batch", True),
                 ("dlrm-dense", "dlrm-mlperf", "train_batch", False),
                 ("deepfm", "deepfm", "train_batch", False),
                 ("autoint", "autoint", "train_batch", False),
                 ("bert4rec", "bert4rec", "train_batch", False),
                 ("full_graph_sm", "graphsage-reddit", "full_graph_sm", False),
                 ("minibatch_lg", "graphsage-reddit", "minibatch_lg", False),
                 ("ogb_products", "graphsage-reddit", "ogb_products", False),
                 ("molecule", "graphsage-reddit", "molecule", False))


@pytest.mark.cuda
@pytest.mark.parametrize("case", PHASE15_CASES, ids=[c[0] for c in PHASE15_CASES])
def test_cuda_train_step_smoke_matches_cpu(cuda, case):
    """chip_smoke.py phase 15 (b): a recsys or GNN train step at its smoke
    config (``configs.common.cell_train_step``), 3 steps from the same
    weights and batch on the card and on the CPU, fp32 with TF32 off:
    losses within 1e-5 relative, every parameter within 5e-5 of its
    max-abs (sums in another order; the sparse update's ``index_add_`` and
    the full-graph aggregate through float atomics on the card; AdamW
    carries a cancelling gradient's rounding into a whole step:
    chip_smoke.py's TRAIN_PARAM_TOL)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = _repo_module("chip_smoke", "chip_smoke.py")
    assert case in smoke.PHASE15_CASES
    rel, worst = smoke.train_card_vs_cpu(*case, cuda)
    assert rel <= 1e-5 and worst <= 5e-5


@pytest.mark.cuda
def test_cuda_recsys_retrieval_example(cuda):
    """examples/recsys_retrieval_torch.py at its defaults (n=20,000, d=32)
    on the card: its own assertions (served == direct bit for bit, no
    filter leak, the cold-start tenant empty), the narrow tenants scanned
    exactly and the recency filter on the graph, recall after rerank."""
    ex = _repo_module("recsys_retrieval_torch", "examples/recsys_retrieval_torch.py")
    out = ex.main(["--device", "cuda"])
    paths = {r["label"]: r["path"] for r in out["requests"]}
    assert paths.pop("recency") == "graph" and set(paths.values()) == {"exact-scan"}
    assert out["stats"]["completed"] == 9 and out["recall"] >= 0.95
