"""The port's kernels: plain versions against ``repro.kernels.ref`` (and the
Pallas bodies in interpret mode) on the CPU, plus dispatch and wrapper
checks. Each CUDA kernel against its plain version, on a GPU, is in
tests/test_torch_cuda.py.

Inputs are made with numpy from a seed; JAX stays on the CPU and data
crosses between the two as numpy.
"""
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nndescent as jnd
from repro.kernels import distance_matrix as pallas_dm
from repro.kernels import flash_attention as pallas_fa  # the function
from repro.kernels import gather_distance as pallas_gd
from repro.kernels import gather_distance_masked as pallas_gdm
from repro.kernels import pq_adc as pallas_pq_adc
from repro.kernels import ref as jref
from repro.kernels.gather_adc import gather_adc_masked as pallas_gam
from repro.kernels.gather_sq8 import gather_sq8_masked as pallas_gsm
from repro_torch.core import convert
from repro_torch.kernels import _build, ops
from repro_torch.kernels import distance_matrix as cuda_dm
from repro_torch.kernels import flash_attention as cuda_fa
from repro_torch.kernels import gather_adc as cuda_ga
from repro_torch.kernels import gather_distance as cuda_gd
from repro_torch.kernels import gather_distance_pool as cuda_gp
from repro_torch.kernels import gather_sq8 as cuda_gs
from repro_torch.kernels import pq_adc as cuda_pa
from repro_torch.kernels import ref
from torch_pool import chunked_pass, pool_world
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

METRICS = ["l2", "ip", "cos"]
# the plain gathers compute the same diff-form / rsqrt formulas as the
# reference in float32; only the summation order may differ
GATHER_TOL = dict(rtol=1e-5, atol=1e-5)
# the matrix's expanded l2 form cancels, so its error scales with the norms
MATRIX_TOL = dict(rtol=1e-5, atol=1e-4)
# ADC scores are sums of M LUT entries: only the summation order may differ
ADC_TOL = dict(rtol=1e-6, atol=1e-6)
# bf16 attention outputs: one bf16 ulp (<= 2^-7 relative) of a cast from
# fp32 values that agree to ~1e-6 (chip_smoke.py's and the card tests' bf16
# FLASH_TOL)
FLASH_BF16_TOL = dict(rtol=1e-2, atol=1e-5)


def _world(Q, R, n, d, seed=0):
    """queries, base, ids with padding (-1) and one all-invalid row, and a
    random uint32 visited bitmap (bit 31 set in about half the words; the
    last word is partial unless n % 32 == 0)."""
    rng = np.random.default_rng(seed + 7 * Q + R + d)
    queries = rng.standard_normal((Q, d), dtype=np.float32)
    base = rng.standard_normal((n, d), dtype=np.float32)
    ids = rng.integers(-1, n, size=(Q, R)).astype(np.int32)
    ids[0] = -1
    visited = rng.integers(0, 2**32, size=(Q, (n + 31) // 32), dtype=np.uint64)
    return queries, base, ids, visited.astype(np.uint32)


def _t(a, dtype=torch.float32):
    return convert.tensor(a, dtype, device="cpu")


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("Q,R,n,d", [(4, 8, 64, 16), (16, 33, 1500, 64),
                                     (2, 5, 33, 100), (3, 1, 7, 3)])
def test_gather_distance_ref_matches_reference(metric, Q, R, n, d):
    queries, base, ids, _ = _world(Q, R, n, d)
    got = ref.gather_distance_ref(_t(queries), _t(ids, torch.int32), _t(base), metric)
    want = jref.gather_distance_ref(jnp.asarray(queries), jnp.asarray(ids),
                                    jnp.asarray(base), metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GATHER_TOL)
    assert np.isinf(got.numpy()[0]).all()  # the all-invalid row


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("Q,R,n,d", [(4, 8, 100, 16), (6, 29, 2048, 48),
                                     (3, 40, 70, 8)])
def test_gather_distance_masked_ref_matches_reference(metric, Q, R, n, d):
    """Masked ids identical, dists within GATHER_TOL, on bitmaps with bit 31
    set and a partial last word."""
    queries, base, ids, visited = _world(Q, R, n, d, seed=1)
    # ids whose bit is bit 31 of a word, and ids in the last (partial) word
    ids[1, :4] = [31, 63, n - 1, ((n - 1) // 32) * 32]
    got_d, got_i = ref.gather_distance_masked_ref(
        _t(queries), _t(ids, torch.int32), _t(base),
        convert.bitmap_from_uint32(visited, "cpu"), metric)
    want_d, want_i = jref.gather_distance_masked_ref(
        jnp.asarray(queries), jnp.asarray(ids), jnp.asarray(base),
        jnp.asarray(visited), metric)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **GATHER_TOL)


def test_visited_mask_bit31_and_partial_word():
    """Hand-built bitmap: bit 31 of word 0 and bit 3 of the partial last
    word are set; exactly those ids are dropped."""
    n = 70                                          # W = 3, last word partial
    visited = np.zeros((1, 3), np.uint32)
    visited[0, 0] = np.uint32(1 << 31)
    visited[0, 2] = np.uint32(1 << 3)               # id 67
    ids = np.array([[31, 30, 67, 66, 69, -1, 0]], np.int32)
    got = ref.visited_mask_ref(_t(ids, torch.int32),
                               convert.bitmap_from_uint32(visited, "cpu"))
    want = jref.visited_mask_ref(jnp.asarray(ids), jnp.asarray(visited))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [[-1, 30, -1, 66, 69, -1, 0]])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("q,n,d", [(8, 128, 16), (37, 101, 24), (1, 7, 4),
                                   (5, 300, 130)])
def test_distance_matrix_ref_matches_reference(metric, q, n, d):
    rng = np.random.default_rng(q * n + d)
    x = rng.standard_normal((q, d), dtype=np.float32)
    y = rng.standard_normal((n, d), dtype=np.float32)
    got = ref.distance_matrix_ref(_t(x), _t(y), metric)
    want = jref.distance_matrix_ref(jnp.asarray(x), jnp.asarray(y), metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MATRIX_TOL)


@pytest.mark.parametrize("metric", METRICS)
def test_distance_matrix_ref_batched_matches_vmapped_reference(metric):
    """The batch dimension is the reference's vmap over vertices (the GD
    occlusion test's (L, L) matrices)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((9, 20, 64), dtype=np.float32)
    got = ref.distance_matrix_ref(_t(x), _t(x), metric)
    want = jax.vmap(lambda m: jref.distance_matrix_ref(m, m, metric))(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MATRIX_TOL)
    for b in range(3):  # each batch entry is the unbatched matrix, exactly
        np.testing.assert_array_equal(
            got[b].numpy(), ref.distance_matrix_ref(_t(x[b]), _t(x[b]), metric).numpy())


@pytest.mark.parametrize("metric", METRICS)
def test_plain_versions_match_pallas_interpret(metric):
    """One small shape against the Pallas bodies themselves (interpret
    mode), as tests/test_kernels.py runs them. The Pallas l2 gather uses
    the expanded form, so its tolerance is the matrix's."""
    queries, base, ids, visited = _world(5, 21, 96, 16, seed=2)
    qt, it, bt = _t(queries), _t(ids, torch.int32), _t(base)
    got = ref.gather_distance_ref(qt, it, bt, metric)
    want = pallas_gd(jnp.asarray(queries), jnp.asarray(ids), jnp.asarray(base),
                     metric=metric, r_tile=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MATRIX_TOL)
    got_d, got_i = ref.gather_distance_masked_ref(
        qt, it, bt, convert.bitmap_from_uint32(visited, "cpu"), metric)
    want_d, want_i = pallas_gdm(jnp.asarray(queries), jnp.asarray(ids),
                                jnp.asarray(base), jnp.asarray(visited),
                                metric=metric, r_tile=8, interpret=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **MATRIX_TOL)
    got_m = ref.distance_matrix_ref(qt, bt, metric)
    want_m = pallas_dm(jnp.asarray(queries), jnp.asarray(base), metric=metric,
                       interpret=True)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), **MATRIX_TOL)



@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("C", [20, 240])
def test_gather_distance_pool_ref_matches_loop_and_reference(metric, C):
    """The pool pass's plain version is the chunked gather_distance_ref loop
    bit for bit, and agrees with the reference's live _score_chunked (its
    plain kernels on the CPU) within 1e-5; n = 1037 is a multiple of no
    window or chunk."""
    n, d, chunk = 1037, 16, 256
    base, pool = pool_world(n, C, d)
    bt, pt = _t(base), _t(pool, torch.int32)
    got = ref.gather_distance_pool_ref(bt, pt, metric, chunk)
    assert torch.equal(got, chunked_pass(ref.gather_distance_ref, bt, pt, metric, chunk))
    assert torch.isinf(got[3]).all() and torch.equal(torch.isinf(got), pt < 0)
    assert torch.equal(got[5, : C // 2], got[5, C // 2: 2 * (C // 2)])
    assert torch.equal(got[6, -1], ref.gather_distance_ref(bt[6:7], pt.new_full(
        (1, 1), n - 1), bt, metric)[0, 0])
    want = jnd._score_chunked(jnp.asarray(base), jnp.asarray(pool), metric, chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,d,C,l2", [(1037, 16, 240, 1 << 20), (5, 3, 1, 256),
                                      (70001, 64, 240, 50 << 20),
                                      (1000, 17, 20, 1 << 16), (33, 700, 7, 1 << 16),
                                      (1 << 20, 64, 20, 50 << 20),
                                      (30001, 960, 20, 50 << 20)])
def test_pool_plan_covers_every_pair_once(n, d, C, l2):
    """The host schedule of the pool kernel: the calls' windows tile the
    rows, each window's hist / scatter chunks tile its pairs, every id maps
    to one (bucket, row) that packs into a non-negative entry, and every
    buffer index stays in int32."""
    plan = cuda_gp.pool_plan(n, d, C, l2)
    R = 1 << plan.log_rows
    assert plan.window * C <= 1 << plan.pos_bits and plan.chunk <= plan.window * C
    assert plan.window * C >= n
    assert plan.pos_bits + plan.log_rows == 31
    assert plan.n_buckets <= cuda_gp.MAX_BUCKETS and (n - 1) >> plan.log_rows < plan.n_buckets
    assert R * d * 4 <= cuda_gp.MAX_STAGE_BYTES and R <= 512
    assert plan.group * plan.window * C < 2**31
    # shared memory: the scatter's sort, the score's staged rows + entry tile
    assert 4 * (2 * plan.n_buckets + plan.chunk) + 128 <= 232448
    assert R * d * 4 + 4 * 1024 <= 232448
    seen = np.zeros(n * C, np.uint8)
    windows = []
    for w0, g in plan.calls():
        assert 1 <= g <= plan.group
        windows += range(w0, w0 + g)
        chunks = -(-plan.window * C // plan.chunk)
        for w in range(w0, w0 + g):
            pairs = min(plan.window, n - w * plan.window) * C
            for b in range(chunks):       # as the kernels bound their blocks
                lo = b * plan.chunk
                if lo < pairs:
                    seen[w * plan.window * C + lo: w * plan.window * C
                         + min(lo + plan.chunk, pairs)] += 1
    assert windows == list(range(plan.n_windows))
    assert (seen == 1).all()
    ids = np.arange(n, dtype=np.int64)
    bucket, row = ids >> plan.log_rows, ids & (R - 1)
    assert np.array_equal(bucket * R + row, ids)
    assert ((row << plan.pos_bits) | (plan.window * C - 1)).max() < 2**31



@pytest.mark.parametrize("C", [1, 2, 3, 7, 20, 240, 241, 1000, 65535, 1 << 22])
@pytest.mark.parametrize("bits", [22, 24, 31])
def test_pool_division_magic_is_exact(C, bits):
    """The score kernel finds a pair's row as (pair * m) >> s in 64 bits:
    exact for every pair < 2**bits, at the edges and at random."""
    m, s = cuda_gp.div_magic(C, bits)
    rng = np.random.default_rng(C + bits)
    xs = [0, 1, C - 1, C, C + 1, (1 << bits) - 1, (1 << bits) - 2]
    xs += [k * C + r for k in (1, 5, ((1 << bits) - 1) // C) for r in (-1, 0, 1)]
    xs += rng.integers(0, 1 << bits, 2000).tolist()
    for x in xs:
        if 0 <= x < 1 << bits:
            assert (x * m) >> s == x // C and x * m < 2**64, (x, C)

def test_pool_plan_raises_on_shapes_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="unsupported shape"):
        cuda_gp.pool_plan(10, cuda_gd.GENERIC_MAX_D + 1, 4, 50 << 20)
    with pytest.raises(ValueError, match="unsupported shape"):
        cuda_gp.pool_plan(2**31, 8, 4, 50 << 20)
    with pytest.raises(ValueError, match="empty shape"):
        cuda_gp.pool_plan(0, 8, 4, 50 << 20)


@pytest.mark.parametrize("n,d,C,staged", [
    (1_000_000, 64, 240, True), (1_000_000, 64, 20, True),   # the build's passes
    (30001, 960, 20, True),
    (30001, 960, 4, False),          # a window holds fewer pairs than n rows
    (1_000_000, 960, 20, False),     # GIST1M: > 8192 buckets of rows that stage
    (1_000_000, 960, 240, False),
    (5_000_000, 8, 20, False),       # > 8192 buckets of 512 rows
    (10_000_000, 32, 240, False),    # RAND10M4D-32D
    (10, 8, (1 << 22) + 1, False),   # C past an entry's pair bits
    (5, 3, 1, True), (1, 1, 1, True)])
def test_pool_plan_goes_direct_where_staging_does_not_pay(n, d, C, staged):
    """On a 50 MiB L2, the plan stages a shape only where its windows hold
    at least n pairs, its buckets stage in shared memory and number at most
    MAX_BUCKETS; every other shape the generic gather takes (d <= GENERIC_MAX_D)
    gets None, one launch of the direct kernel, and no exception."""
    plan = cuda_gp.pool_plan(n, d, C, 50 << 20)
    assert (plan is not None) == staged
    if plan is not None:
        assert plan.window * C >= n and plan.n_buckets <= cuda_gp.MAX_BUCKETS
        assert (4 * d) << plan.log_rows <= cuda_gp.MAX_STAGE_BYTES


def test_group_tree_adds_the_plain_trees_pairs():
    """The pool kernel holds a row's 32 lane partials in 8 lanes (lane u:
    partials 4u..4u+3) and sums them with group_tree
    (csrc/gather_distance_pool.cu); emulated in float32, every lane ends with
    the bits of the plain xor tree (common.cuh warp_sum)."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    for _ in range(200):
        part = (rng.standard_normal(32) * 10.0 ** rng.integers(-4, 5, 32)).astype(f32)
        v = part.copy()
        for o in (16, 8, 4, 2, 1):
            v = (v + v[np.arange(32) ^ o]).astype(f32)
        lanes = np.arange(8)
        p = part.reshape(8, 4)                       # p[u, c] = partial 4u + c
        hi4 = (lanes & 4) != 0
        keep0, send0 = np.where(hi4, p[:, 2], p[:, 0]), np.where(hi4, p[:, 0], p[:, 2])
        keep1, send1 = np.where(hi4, p[:, 3], p[:, 1]), np.where(hi4, p[:, 1], p[:, 3])
        a0 = (keep0 + send0[lanes ^ 4]).astype(f32)
        a1 = (keep1 + send1[lanes ^ 4]).astype(f32)
        hi2 = (lanes & 2) != 0
        b = (np.where(hi2, a1, a0) + np.where(hi2, a0, a1)[lanes ^ 2]).astype(f32)
        for x in (1, 4, 2):
            b = (b + b[lanes ^ x]).astype(f32)
        assert all(b[u].tobytes() == v[0].tobytes() for u in range(8))


def _fma(a, b, c):
    """fmaf emulated in float64: the product of two float32 values is exact
    there, then one rounding to float32."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _xor_tree(v):
    """common.cuh warp_sum over the last axis of (..., 32) float32 lane
    partials: every lane's value after 16, 8, 4, 2, 1."""
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., np.arange(32) ^ o]).astype(np.float32)
    return v


def _emulated_group_tree(p):
    """group_tree (csrc/common.cuh) on (..., 8, 4) partials, lane u holding
    4u..4u+3; returns (..., 8), one value a lane."""
    lanes = np.arange(8)
    hi4 = (lanes & 4) != 0
    keep0 = np.where(hi4, p[..., 2], p[..., 0])
    send0 = np.where(hi4, p[..., 0], p[..., 2])
    keep1 = np.where(hi4, p[..., 3], p[..., 1])
    send1 = np.where(hi4, p[..., 1], p[..., 3])
    a0 = (keep0 + send0[..., lanes ^ 4]).astype(np.float32)
    a1 = (keep1 + send1[..., lanes ^ 4]).astype(np.float32)
    hi2 = (lanes & 2) != 0
    b = (np.where(hi2, a1, a0) + np.where(hi2, a0, a1)[..., lanes ^ 2]).astype(np.float32)
    for x in (1, 4, 2):
        b = (b + b[..., lanes ^ x]).astype(np.float32)
    return b


def _emulated_sums(rows, qrows, metric, lane_of):
    """(acc, rr, qq), each (P, 32) lane partials of P (row, query) pairs: the
    partial lane_of(col) adds column col's term with fmaf, columns visited in
    the order ``lane_of`` yields them."""
    P, d = rows.shape
    acc, rr, qq = (np.zeros((P, 32), np.float32) for _ in range(3))
    for col, m in lane_of(d):
        x, y = rows[:, col], qrows[:, col]
        if metric == "l2":
            df = (x - y).astype(np.float32)
            acc[:, m] = _fma(df, df, acc[:, m])
        else:
            acc[:, m] = _fma(x, y, acc[:, m])
            rr[:, m] = _fma(x, x, rr[:, m])
            qq[:, m] = _fma(y, y, qq[:, m])
    return acc, rr, qq


def _generic_lanes(d):
    """gather_distance_kernel: lane l adds columns l, l + 32, ... < d."""
    for j in range(d):
        yield j, j % 32


def _hop_lanes(d):
    """gather_distance_hop_kernel (common.cuh group_distances, one row a
    group): KB 32-column chunks a step; lane u's float4 covers columns
    jb + 32k + 4u .. + 3, held as partials 4u + c; columns past d skipped."""
    kb = 1 if d <= 32 else 2 if d <= 64 else 4
    for jb in range(0, d, 32 * kb):
        for k in range(kb):
            for u in range(8):
                for c in range(4):
                    col = jb + 32 * k + 4 * u + c
                    if col < d:
                        yield col, 4 * u + c


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [1, 5, 17, 50, 100, 130])
def test_hop_lane_layout_gives_the_plain_sum(metric, d):
    """The hop kernel's lane layout, emulated in float32 at ragged d: its
    partials are the generic kernel's, summed in the same column order, and
    group_tree gives warp_sum's bits in every lane; the distance lies within
    GATHER_TOL of the plain version and of the JAX reference (diff-form l2,
    as both)."""
    queries, base, ids, _ = _world(6, 9, 300, d, seed=5)
    ids[ids >= 0] = np.minimum(ids[ids >= 0] + 5, 299)   # a few ids at n - 1
    ok = ids >= 0
    rows = base[ids[ok]]
    qrows = np.repeat(queries, ids.shape[1], axis=0)[ok.ravel()]
    hop = _emulated_sums(rows, qrows, metric, _hop_lanes)
    generic = _emulated_sums(rows, qrows, metric, _generic_lanes)
    for h, g in zip(hop, generic):
        assert h.tobytes() == g.tobytes()
    sums = []
    for part in hop:
        tree = _emulated_group_tree(part.reshape(-1, 8, 4))
        assert (tree == tree[:, :1]).all()
        assert tree[:, 0].tobytes() == _xor_tree(part)[:, 0].tobytes()
        sums.append(tree[:, 0])
    acc, rr, qq = sums
    if metric == "l2":
        dist = acc
    elif metric == "ip":
        dist = -acc
    else:
        rq = (1.0 / np.sqrt(np.maximum(qq, np.float32(1e-12)))).astype(np.float32)
        rs = (1.0 / np.sqrt(np.maximum(rr, np.float32(1e-12)))).astype(np.float32)
        dist = (1.0 - acc * rq * rs).astype(np.float32)
    got = np.full(ids.shape, np.inf, np.float32)
    got[ok] = dist
    want = ref.gather_distance_ref(_t(queries), _t(ids, torch.int32), _t(base), metric)
    np.testing.assert_allclose(got, want.numpy(), **GATHER_TOL)
    jwant = jref.gather_distance_ref(jnp.asarray(queries), jnp.asarray(ids),
                                     jnp.asarray(base), metric)
    np.testing.assert_allclose(got, np.asarray(jwant), **GATHER_TOL)


@pytest.mark.parametrize("shape,tile,grid", [
    ((1, 512, 16384, 64), 128, (128, 4)),        # a ground-truth chunk
    ((1, 512, 576, 64), 128, (5, 4)),            # its last chunk at n = 1M
    ((65536, 20, 20, 64), 32, (264, 1)),         # a GD block: 2 blocks an SM
    ((1000, 32, 32, 64), 32, (125, 1)),          # the small route's edge
    ((1000, 33, 32, 64), 128, (1000, 1)),
    ((1, 32, 33, 8), 128, (1, 1)),
    ((5, 7, 3, 130), 32, (1, 1)),
    ((3, 200, 150, 64), 128, (6, 2)),            # B > 1 on the large route
    ((1, 129, 257, 960), 128, (3, 2)),
    ((1, 1, 1, 1), 32, (1, 1)),
    ((1, 0, 5, 4), 32, (1, 1))])
def test_matrix_route_picks_the_tile_and_grid(shape, tile, grid):
    """The small route only where both sides are at most 32 wide (the GD
    batch): a persistent grid of 8-warp blocks, 2 an SM of the H100's 132,
    fewer where B needs fewer. Else the 128 x 128 tile: grid x holds B x
    the n-tiles, y the q-tiles."""
    assert cuda_dm.matrix_route(*shape) == (tile, grid)


@pytest.mark.parametrize("shape", [
    (1, 65535 * 128 + 1, 64, 8),       # q-tiles past gridDim.y
    (2**20, 64, 2**18, 8),             # B x n-tiles past gridDim.x
    (1, 64, 64, 2**31),                # d past int32
    (2**31, 20, 20, 64),               # small route: B past int32
    (4, 20, 20, 2**31),                # small route: d past int32
    (1, -1, 4, 4)])
def test_matrix_route_rejects_what_the_grid_cannot_take(shape):
    with pytest.raises(ValueError, match="launch grid|negative"):
        cuda_dm.matrix_route(*shape)
    assert cuda_dm.matrix_route(1, 65535 * 128, 64, 8) == (128, (1, 65535))
    assert cuda_dm.matrix_route(2**31 - 1, 20, 20, 64, sms=132) == (32, (264, 1))


@pytest.mark.parametrize("q,n,d,same", [(20, 20, 64, True), (20, 20, 64, False),
                                        (32, 32, 960, False), (32, 32, 960, True),
                                        (7, 3, 130, False), (1, 1, 1, True),
                                        (5, 9, 17, False), (32, 1, 0, False)])
def test_small_plan_fits_two_blocks_an_sm(q, n, d, same):
    """The small route's stages: kc a multiple of 4 up to 64 (the whole row
    at the GD shape), a row stride with stride / 4 odd, and shared memory
    for two 8-warp blocks an SM of the H100 (228 KB, 1 KB reserved a
    block); kc is the widest that fits."""
    plan = cuda_dm.small_plan(q, n, d, same)
    assert plan.kc % 4 == 0 and 4 <= plan.kc <= cuda_dm.MAX_KC
    assert plan.stride >= plan.kc and plan.stride % 4 == 0 and (plan.stride // 4) % 2 == 1
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    rows = q if same else q + n
    room = cuda_dm.SMALL_WARP_FLOATS - 4 * -(-q * n // 4) - cuda_dm.NORM_SLOTS
    assert plan.smem_bytes == 4 * cuda_dm.SMALL_WARPS * (
        2 * rows * plan.stride + 4 * -(-q * n // 4) + cuda_dm.NORM_SLOTS)
    wider = plan.kc + 4
    assert (wider > min(cuda_dm.MAX_KC, 4 * -(-d // 4))
            or 2 * rows * cuda_dm._stride(wider) > room)
    if (q, n, d, same) == (20, 20, 64, True):   # the GD block: one stage a matrix
        assert plan == (64, 68, 101888)
    for bad in ((0, 4, 8, False), (33, 4, 8, False), (4, 5, 8, True), (4, 4, -1, False)):
        with pytest.raises(ValueError, match="small-route"):
            cuda_dm.small_plan(*bad)


@pytest.mark.parametrize("q,n", [(20, 20), (32, 32), (1, 1), (7, 3), (17, 29), (32, 5)])
def test_small_route_lanes_cover_each_output_once(q, n):
    """The small kernel's lane layout (csrc/distance_matrix.cu): lane t of
    pass p holds block b = 32p + t of the RB x CB blocks, rows bi + RB*i and
    columns bj + CB*j; the valid ones cover every output of a q x n matrix
    exactly once, no lane holds only padding, and the GD shape needs one
    pass of 25 lanes."""
    RB, CB = -(-q // 4), -(-n // 4)
    passes = 2 if RB * CB > 32 else 1
    seen = np.zeros((q, n), np.int32)
    for b in range(RB * CB):
        bi, bj = divmod(b, CB)
        cells = [(bi + RB * i, bj + CB * j) for i in range(4) for j in range(4)]
        valid = [(r, c) for r, c in cells if r < q and c < n]
        assert valid
        for r, c in valid:
            seen[r, c] += 1
    assert (seen == 1).all()
    assert RB * CB <= 32 * passes
    if (q, n) == (20, 20):
        assert (RB * CB, passes) == (25, 1)


@pytest.mark.parametrize("q", [20, 17, 16, 12, 5, 1])
def test_symmetric_small_route_covers_each_output(q):
    """The small kernel's SYM layout (x is y, q <= 20): lane t holds half t
    % 2 of block t // 2 of the blocks on or above the diagonal (rows bi +
    RB*i, columns bj + RB*(2h + j), bi <= bj) and writes (r, c) and (c, r);
    together the lanes write every output, and every output is written from
    the dot product of its own (r, c) pair or of (c, r), which an fmaf chain
    gives with the same bits. 30 of 32 lanes at 20 x 20."""
    RB = -(-q // 4)
    half_blocks = RB * (RB + 1)
    assert half_blocks <= 32
    written = np.zeros((q, q), np.int32)
    for lane in range(half_blocks):
        t, bi = lane >> 1, 0
        while t >= RB - bi:
            t -= RB - bi
            bi += 1
        bj = bi + t
        assert bi <= bj < RB
        for i in range(4):
            for j in range(2):
                r, c = bi + RB * i, bj + RB * (2 * (lane & 1) + j)
                if r < q and c < q:
                    written[r, c] += 1
                    written[c, r] += 1
    assert (written >= 1).all()
    assert (written[~np.eye(q, dtype=bool)] <= 2).all()
    if q == 20:
        assert half_blocks == 30


@pytest.mark.parametrize("case", ["unknown metric", "float64 base", "int64 pool",
                                  "3-D base", "rows differ", "non-contiguous pool",
                                  "non-contiguous base", "cpu tensors"])
def test_pool_wrapper_rejects_what_it_does_not_take(case):
    """The CUDA wrapper raises on each of these before it builds or launches
    anything."""
    base, pool = pool_world(40, 6, 8)
    bt, pt, metric = _t(base), _t(pool, torch.int32), "l2"
    match = {"unknown metric": "unknown metric", "float64 base": "float32",
             "int64 pool": "int32", "3-D base": "2-D", "rows differ": "2-D",
             "non-contiguous pool": "pool must be contiguous",
             "non-contiguous base": "base must be contiguous",
             "cpu tensors": "CUDA tensor"}[case]
    if case == "unknown metric":
        metric = "hamming"
    elif case == "float64 base":
        bt = bt.double()
    elif case == "int64 pool":
        pt = pt.long()
    elif case == "3-D base":
        bt = bt[None]
    elif case == "rows differ":
        pt = pt[:-1]
    elif case == "non-contiguous pool":
        pt = _t(pool.T.copy(), torch.int32).t()
    elif case == "non-contiguous base":
        bt = _t(base.T.copy()).t()
    with pytest.raises(ValueError, match=match):
        cuda_gp.gather_distance_pool(bt, pt, metric)
    assert cuda_gp._fn is None and cuda_gp.LAUNCHES["gather_distance_pool"] == 0

def _codes_world(Q, R, n, d, M, K, seed=0):
    """ids with padding, an all-invalid row and ids on bit 31 and in the
    partial last word; a random uint32 visited bitmap; sq8 codes with
    scale/mn (one zero-range dimension: scale 1); PQ codes and LUTs."""
    rng = np.random.default_rng(seed + 11 * Q + R + M)
    queries = rng.standard_normal((Q, d), dtype=np.float32)
    ids = rng.integers(-1, n, size=(Q, R)).astype(np.int32)
    ids[0] = -1
    if Q > 1 and R >= 4:
        ids[1, :4] = [min(31, n - 1), min(63, n - 1), n - 1, ((n - 1) // 32) * 32]
    visited = rng.integers(0, 2**32, size=(Q, (n + 31) // 32), dtype=np.uint64)
    visited = visited.astype(np.uint32)
    visited[:, 0] |= np.uint32(1 << 31)
    sq_codes = rng.integers(0, 256, size=(n, d)).astype(np.uint8)
    scale = (rng.random(d).astype(np.float32) + 0.1) / 64
    scale[0] = 1.0
    mn = rng.standard_normal(d, dtype=np.float32)
    pq_codes = rng.integers(0, K, size=(n, M)).astype(np.uint8)
    luts = rng.standard_normal((Q, M, K), dtype=np.float32)
    return dict(queries=queries, ids=ids, visited=visited, sq_codes=sq_codes,
                scale=scale, mn=mn, pq_codes=pq_codes, luts=luts)


def _u8(a):
    return convert.tensor(a, torch.uint8, device="cpu")


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("Q,R,n,d", [(4, 8, 100, 16), (6, 29, 2048, 32),
                                     (3, 40, 70, 8), (2, 5, 33, 3)])
def test_gather_sq8_masked_ref_matches_reference(metric, Q, R, n, d):
    """Masked ids identical, dists within GATHER_TOL, with ids < 0, an
    all-invalid row, bit 31 and a partial last word."""
    w = _codes_world(Q, R, n, d, 4, 16, seed=3)
    got_d, got_i = ref.gather_sq8_masked_ref(
        _t(w["queries"]), _t(w["ids"], torch.int32), _u8(w["sq_codes"]),
        _t(w["scale"]), _t(w["mn"]), convert.bitmap_from_uint32(w["visited"], "cpu"),
        metric)
    want_d, want_i = jref.gather_sq8_masked_ref(
        jnp.asarray(w["queries"]), jnp.asarray(w["ids"]), jnp.asarray(w["sq_codes"]),
        jnp.asarray(w["scale"]), jnp.asarray(w["mn"]), jnp.asarray(w["visited"]),
        metric)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **GATHER_TOL)
    assert np.isinf(got_d.numpy()[0]).all()
    unmasked = ref.gather_sq8_ref(_t(w["queries"]), _t(w["ids"], torch.int32),
                                  _u8(w["sq_codes"]), _t(w["scale"]), _t(w["mn"]), metric)
    np.testing.assert_allclose(
        unmasked.numpy(),
        np.asarray(jref.gather_sq8_ref(jnp.asarray(w["queries"]), jnp.asarray(w["ids"]),
                                       jnp.asarray(w["sq_codes"]), jnp.asarray(w["scale"]),
                                       jnp.asarray(w["mn"]), metric)), **GATHER_TOL)


def _sq8_word_lanes(d):
    """gather_sq8_kernel's word order (d % 4 == 0, a 4-byte aligned table):
    lane l adds columns 4w .. 4w + 3 of words w = l, l + 32, ..."""
    for w in range(d // 4):
        for c in range(4):
            yield 4 * w + c, w % 32


def _sq8_group_word_lanes(d):
    """gather_sq8_hop_kernel's word order (common.cuh group_sq8_distance):
    128-column chunks; lane u of the group holds partials 4u + c', columns
    128t + 16u + 4c' .. + 3 (one 16-byte code load)."""
    for jb in range(0, d, 128):
        for u in range(8):
            for cp in range(4):
                col0 = jb + 16 * u + 4 * cp
                if col0 < d:
                    for c in range(4):
                        yield col0 + c, 4 * u + cp


def _sq8_group_byte_lanes(d):
    """gather_sq8_hop_kernel's byte order: 32-column chunks, lane u holds
    partials 4u + c, columns 32t + 4u + c."""
    for jb in range(0, d, 32):
        for u in range(8):
            for c in range(4):
                if jb + 4 * u + c < d:
                    yield jb + 4 * u + c, 4 * u + c


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d,path", [(d, "bytes") for d in (1, 5, 17, 50, 100, 130)]
                         + [(d, "words") for d in (4, 20, 64, 100, 132, 260)])
def test_sq8_hop_lane_layout_gives_the_generic_sum(metric, d, path):
    """The sq8 hop kernel's group layout, emulated in float32 at ragged d, on
    the word path (d % 4 == 0) and the byte path: its partials are the
    generic sq8 kernel's, each summed in the same column order (the query's
    norm in the byte order on both), and group_tree gives warp_sum's bits;
    the distance lies within GATHER_TOL of the plain version and of the JAX
    reference's plain gather_sq8, masked and unmasked."""
    w = _codes_world(6, 9, 300, d, 4, 16, seed=d)
    ids = w["ids"]
    ok = ids >= 0
    rows = _fma(w["sq_codes"][ids[ok]].astype(np.float32), w["scale"], w["mn"])
    qrows = np.repeat(w["queries"], ids.shape[1], axis=0)[ok.ravel()]
    generic_lanes, group_lanes = ((_sq8_word_lanes, _sq8_group_word_lanes) if path == "words"
                                  else (_generic_lanes, _sq8_group_byte_lanes))
    acc, rr, _ = _emulated_sums(rows, qrows, metric, group_lanes)
    g_acc, g_rr, _ = _emulated_sums(rows, qrows, metric, generic_lanes)
    qq = _emulated_sums(rows, qrows, metric, _sq8_group_byte_lanes)[2]
    g_qq = _emulated_sums(rows, qrows, metric, _generic_lanes)[2]
    for h, g in ((acc, g_acc), (rr, g_rr), (qq, g_qq)):
        assert h.tobytes() == g.tobytes()
    sums = []
    for part in (acc, rr, qq):
        tree = _emulated_group_tree(part.reshape(-1, 8, 4))
        assert (tree == tree[:, :1]).all()
        assert tree[:, 0].tobytes() == _xor_tree(part)[:, 0].tobytes()
        sums.append(tree[:, 0])
    a, r2, q2 = sums
    if metric == "l2":
        dist = a
    elif metric == "ip":
        dist = -a
    else:
        rq = (1.0 / np.sqrt(np.maximum(q2, np.float32(1e-12)))).astype(np.float32)
        rs = (1.0 / np.sqrt(np.maximum(r2, np.float32(1e-12)))).astype(np.float32)
        dist = (1.0 - a * rq * rs).astype(np.float32)
    got = np.full(ids.shape, np.inf, np.float32)
    got[ok] = dist
    args = (_t(w["queries"]), _t(ids, torch.int32), _u8(w["sq_codes"]), _t(w["scale"]),
            _t(w["mn"]))
    np.testing.assert_allclose(got, ref.gather_sq8_ref(*args, metric).numpy(), **GATHER_TOL)
    jwant = jref.gather_sq8_ref(*(jnp.asarray(w[k]) for k in ("queries", "ids", "sq_codes",
                                                              "scale", "mn")), metric)
    np.testing.assert_allclose(got, np.asarray(jwant), **GATHER_TOL)
    # the mask epilogue: the visited bit read last, padding and visited ids out
    word = w["visited"][np.arange(ids.shape[0])[:, None],
                        np.minimum(np.maximum(ids, 0) >> 5, w["visited"].shape[1] - 1)]
    seen = ok & (((word >> (np.maximum(ids, 0) & 31).astype(np.uint32)) & 1) == 1)
    want_d, want_i = ref.gather_sq8_masked_ref(
        *args, convert.bitmap_from_uint32(w["visited"], "cpu"), metric)
    np.testing.assert_array_equal(np.where(seen | ~ok, -1, ids), want_i.numpy())
    np.testing.assert_allclose(np.where(seen, np.inf, got), want_d.numpy(), **GATHER_TOL)


@pytest.mark.parametrize("Q,R,n,d,W", [
    (2**20, 2**15, 10, 8, 1),          # Q x R pairs past 2^31 - 1 blocks of 16
    (1, 1, 2**31, 8, 1),               # n past int32
    (1, 1, 10, 2**31, 1),              # d past int32
    (1, 1, 0, 8, 1),                   # an empty table
    (1, 1, 10, 8, 0)])                 # no visited words
def test_sq8_hop_grid_rejects_what_it_cannot_take(Q, R, n, d, W):
    """The hop wrapper's limits follow its grid (Q x R pairs, 16 a block)
    and its int32 indexing, and are raised before any launch; the generic
    kernel's 48 KB staging and R-tile limits no longer apply to it."""
    with pytest.raises(ValueError, match="hop kernel's grid|unsupported shape"):
        cuda_gs.hop_grid(Q, R, n, d, W)
    assert cuda_gs.hop_grid(64, 20, 10**6, 64, 31250) == 80
    assert cuda_gs.hop_grid(3, 32 * 65536, 10, 8192, 1) == -(-3 * 32 * 65536 // 16)
    assert cuda_gs.hop_grid(2**20, 2**15 - 1, 10, 8, 1) == 2**31 - 2**16
    assert cuda_gs._hop_fn is None and cuda_gs.LAUNCHES["gather_sq8_masked"] == 0


@pytest.mark.parametrize("M", [4, 8])
@pytest.mark.parametrize("Q,R,n,K", [(4, 8, 100, 16), (6, 29, 2048, 256),
                                     (3, 40, 70, 256), (2, 1, 5, 3)])
def test_gather_adc_masked_ref_matches_reference(M, Q, R, n, K):
    w = _codes_world(Q, R, n, 8, M, K, seed=5)
    it, ct, lt = _t(w["ids"], torch.int32), _u8(w["pq_codes"]), _t(w["luts"])
    got_d, got_i = ref.gather_adc_masked_ref(
        it, ct, lt, convert.bitmap_from_uint32(w["visited"], "cpu"))
    want_d, want_i = jref.gather_adc_masked_ref(
        jnp.asarray(w["ids"]), jnp.asarray(w["pq_codes"]), jnp.asarray(w["luts"]),
        jnp.asarray(w["visited"]))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **ADC_TOL)
    np.testing.assert_allclose(
        ref.gather_adc_ref(it, ct, lt).numpy(),
        np.asarray(jref.gather_adc_ref(jnp.asarray(w["ids"]), jnp.asarray(w["pq_codes"]),
                                       jnp.asarray(w["luts"]))), **ADC_TOL)


@pytest.mark.parametrize("M", [4, 8])
@pytest.mark.parametrize("n,K", [(1000, 256), (37, 16), (1, 1)])
def test_pq_adc_ref_matches_reference(M, n, K):
    """One LUT and a batch of LUTs; each batch row is the one-LUT scan,
    bit for bit."""
    w = _codes_world(3, 1, n, 8, M, K, seed=6)
    ct, lt = _u8(w["pq_codes"]), _t(w["luts"])
    got = ref.pq_adc_ref(ct, lt)
    assert got.shape == (3, n)
    for q in range(3):
        want = jref.pq_adc_ref(jnp.asarray(w["pq_codes"]), jnp.asarray(w["luts"][q]))
        np.testing.assert_allclose(got[q].numpy(), np.asarray(want), **ADC_TOL)
        assert torch.equal(ref.pq_adc_ref(ct, lt[q]), got[q])


def test_adc_plain_versions_sum_in_m_order():
    """The plain ADC versions add the M entries one at a time from 0.0 in
    m order, the order the CUDA kernels use: float32 entries 1, 1e8, -1e8,
    1 sum to 1.0 in that order (a pairwise order gives 0.0)."""
    lut = torch.tensor([[[1.0], [1e8], [-1e8], [1.0]]], dtype=torch.float32)
    codes = torch.zeros((1, 4), dtype=torch.uint8)
    f = np.float32
    in_order = ((f(1.0) + f(1e8)) + f(-1e8)) + f(1.0)
    assert in_order == 1.0 and (f(1.0) + f(1e8)) + (f(-1e8) + f(1.0)) == 0.0
    assert ref.pq_adc_ref(codes, lut[0]).item() == in_order
    assert ref.gather_adc_ref(torch.zeros((1, 1), dtype=torch.int32), codes,
                              lut).item() == in_order


def _funnelshift_l(lo, hi, shift):
    """__funnelshift_l: the high word of (hi:lo) << shift, shift < 32."""
    both = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((both << shift.astype(np.uint64)) >> np.uint64(32)).astype(np.uint32)


def _distinct_banks(words):
    """One wavefront: the words a warp reads or writes sit in 32 distinct
    banks (a word read by several lanes counts once)."""
    words = np.unique(np.asarray(words))
    return len(np.unique(words % 32)) == len(words)


def _interleaved_scan(codes, luts):
    """pq_adc_interleaved_kernel (csrc/pq_adc.cu) in numpy float32, step by
    step: the LUTs of 16 queries staged as entry (c, m, q) at (c * M + m) *
    16 + q; tiles of 64 rows in a code buffer (half 1's rows 16 bytes past
    half 0's); lane (h, q) reads its row's code words, half 1's stream
    shifted one byte (funnel shift), looks up slot k at c * 16M + 16m + q
    (m = k; half 1 one m behind), adds in the kernel's order, writes the
    transpose row of 66 floats and the tile is read back. Also checks
    that every warp lookup, transpose store, code load and LUT staging
    store is one wavefront."""
    n, M = codes.shape
    Q, _, K = luts.shape
    QB, T, S, GAP = 16, 32, 66, 16
    lane = np.arange(32)
    q, h = lane & 15, lane >> 4
    out = np.full((Q, n), np.nan, np.float32)
    shift = (8 * h).astype(np.uint32)
    # slot k reads m = k, half 1 m = k - 1 and at slot 0 m = M - 1 of its last row
    at = [np.where(h == 1, M - 1 if k == 0 else k - 1, k) * QB + q for k in range(M)]
    col = q * S + h * (T - 1)
    for p in range(M // 2):          # LUT staging: lane (q, h) stores m = 2p + h
        for c in (0, K - 1):
            assert _distinct_banks((c * M + 2 * p + h) * QB + q)
    for q0 in range(0, Q, QB):
        qn = min(QB, Q - q0)
        staged = np.zeros((QB, M, K), np.float32)
        staged[:qn] = luts[q0:q0 + qn]
        lut = staged.transpose(2, 1, 0).reshape(-1)            # (c, m, q)
        for row0 in range(0, n, 2 * T):
            tile = np.zeros((2 * T, M), np.uint8)
            rows = codes[row0:row0 + 2 * T]
            tile[:len(rows)] = rows
            buf = np.zeros(2 * T * M + GAP, np.uint8)
            buf[:T * M] = tile[:T].ravel()
            buf[T * M + GAP:] = tile[T:].ravel()
            w32 = buf.view("<u4")
            tq = np.full(QB * S, np.nan, np.float32)
            prev = np.zeros(32, np.uint32)
            acc = np.zeros(32, np.float32)
            for j in range(T):
                first = (h * (T * M + GAP) + j * M) // 4       # the lane's row, in words
                if j % (16 // M) == 0:                          # a 16-byte code load
                    assert _distinct_banks(first[:, None] + np.arange(4))
                w = w32[first[:, None] + np.arange(M // 4)]
                s = np.stack([_funnelshift_l(prev if i == 0 else w[:, i - 1], w[:, i], shift)
                              for i in range(M // 4)], axis=1)
                prev = w[:, -1]
                e = []
                for k in range(M):
                    c = (s[:, k >> 2] >> np.uint32(8 * (k & 3))) & np.uint32(0xFF)
                    idx = c.astype(np.int64) * (M * QB) + at[k]
                    assert _distinct_banks(idx)
                    e.append(lut[idx])
                done = np.where(h == 1, acc, np.float32(0)) + e[0]
                a = np.where(h == 1, np.float32(0), done) + e[1]
                for k in range(2, M):
                    a = a + e[k]
                acc = a
                # half 1's store at j = 0 lands on half 0's column 31, rewritten at j = 31
                assert _distinct_banks(col + j)
                tq[col + j] = np.where(h == 1, done, a)
            last = (prev >> np.uint32(24)).astype(np.int64) * (M * QB) + at[0]
            tq[(col + T)[h == 1]] = (acc + lut[last])[h == 1]
            assert _distinct_banks((col + T)[h == 1])
            keep = min(2 * T, n - row0)
            for jq in range(qn):
                out[q0 + jq, row0:row0 + keep] = tq[jq * S:jq * S + keep]
    return out


@pytest.mark.parametrize("M", [4, 8, 16])
@pytest.mark.parametrize("K", [16, 256])
@pytest.mark.parametrize("Q,n", [(21, 130), (16, 64), (33, 1)])
def test_pq_adc_interleaved_layout_gives_the_plain_sum(M, K, Q, n):
    """The interleaved kernel's layout, emulated in float32 at ragged n and
    Q not a multiple of 16 (a partial last query group, a partial last
    tile): its scores equal ref.pq_adc_ref and the JAX Pallas pq_adc in
    interpret mode bit for bit, every (query, row) one add chain from 0.0
    in m order, and every warp lookup is one wavefront whatever the codes
    (checked on uniform codes and on rows whose codes are all equal)."""
    w = _codes_world(Q, 1, n, 8, M, K, seed=M + K)
    codes, luts = w["pq_codes"], w["luts"]
    for table in (codes, np.repeat(codes[:1], n, axis=0)):
        got = _interleaved_scan(table, luts)
        want = ref.pq_adc_ref(_u8(table), _t(luts)).numpy()
        assert got.tobytes() == want.tobytes()
        jwant = jax.vmap(lambda lut, t=jnp.asarray(table): pallas_pq_adc(
            t, lut, block_n=64, interpret=True))(jnp.asarray(luts))
        assert got.tobytes() == np.asarray(jwant).tobytes()


def _hop_adc(ids, codes, luts, visited, vec8):
    """gather_adc_hop_kernel (csrc/gather_adc.cu) in numpy float32, one
    thread a pair: a padding id stores (+inf, -1) first; the visited word
    (clamped to the last) and the code row (ids past n - 1 read row n - 1)
    load together, with ``vec8`` as 8-byte words whose bytes are the codes
    m = 8w .. 8w + 7 in order; the M entries add from 0.0 in m order; the
    visited bit applies at the store."""
    Q, R = ids.shape
    n, M = codes.shape
    W = visited.shape[1]
    qq = np.repeat(np.arange(Q), R)
    idv = ids.ravel()
    pad = idv < 0
    idc = np.where(pad, 0, idv)
    word = visited[qq, np.minimum(idc >> 5, W - 1)]
    rows = np.ascontiguousarray(codes[np.minimum(idc, n - 1)])
    if vec8:    # uint2 loads: byte b of word x (b < 4) or y holds code 8w + b
        words = rows.view("<u4").reshape(len(idv), M // 8, 2)
        rows = np.stack([(words[:, w, b >> 2] >> np.uint32(8 * (b & 3))) & np.uint32(0xFF)
                         for w in range(M // 8) for b in range(8)], axis=1)
    acc = np.zeros(len(idv), np.float32)
    for m in range(M):
        acc = acc + luts[qq, m, rows[:, m]]
    seen = ((word >> (idc & 31).astype(np.uint32)) & 1) == 1
    drop = pad | seen
    return (np.where(drop, np.float32(np.inf), acc).reshape(Q, R),
            np.where(drop, -1, idv).astype(np.int32).reshape(Q, R))


@pytest.mark.parametrize("M", [4, 8, 16, 40])
@pytest.mark.parametrize("K", [16, 256])
def test_adc_hop_gives_the_plain_sum(M, K):
    """The ADC hop kernel, emulated in float32 on the 8-byte code loads
    (M % 8 == 0) and on the byte loads: with padding ids, an all-padding
    row, a row of visited ids, ids past n - 1 and bit 31, its dists and
    ids equal ref.gather_adc_masked_ref and the JAX Pallas
    gather_adc_masked in interpret mode bit for bit."""
    Q, R, n = 6, 21, 300
    w = _codes_world(Q, R, n, 8, M, K, seed=M * K)
    ids, visited = w["ids"].copy(), w["visited"].copy()
    visited[2] = 2**32 - 1
    ids[3, ::2] = n + np.arange(ids[3, ::2].size) % 40
    want_d, want_i = ref.gather_adc_masked_ref(
        _t(ids, torch.int32), _u8(w["pq_codes"]), _t(w["luts"]),
        convert.bitmap_from_uint32(visited, "cpu"))
    jd, ji = pallas_gam(jnp.asarray(ids), jnp.asarray(w["pq_codes"]), jnp.asarray(w["luts"]),
                        jnp.asarray(visited), r_tile=8, interpret=True)
    for vec8 in {False, M % 8 == 0}:
        got_d, got_i = _hop_adc(ids, w["pq_codes"], w["luts"], visited, vec8)
        assert np.isinf(got_d[0]).all() and (got_i[2] == -1).all()
        np.testing.assert_array_equal(got_i, want_i.numpy())
        assert got_d.tobytes() == want_d.numpy().tobytes()
        np.testing.assert_array_equal(got_i, np.asarray(ji))
        assert got_d.tobytes() == np.asarray(jd).tobytes()


@pytest.mark.parametrize("Q,M,K,ptr,route", [
    (1, 8, 256, 0, "generic"),          # a single LUT
    (15, 8, 256, 0, "generic"),         # Q < 16: no full query group
    (16, 8, 256, 0, "interleaved"),
    (64, 8, 256, 0, "interleaved"),     # the pq_search chunk
    (64, 8, 256, 8, "interleaved"),     # a table at an 8-byte offset: 4-byte copies
    (64, 8, 256, 2, "generic"),         # not 4-byte aligned
    (64, 4, 256, 0, "interleaved"),
    (64, 16, 16, 0, "interleaved"),
    (64, 16, 256, 0, "generic"),        # 16 LUTs of 16 KB: past shared memory
    (64, 12, 16, 0, "generic"),         # M the kernel does not read as words
    (64, 2, 256, 0, "generic")])
def test_pq_adc_route_picks_the_kernel_from_the_shapes(Q, M, K, ptr, route):
    """scan_route sends a pq_adc call to the interleaved kernel where it pays
    and fits, else to the generic one; the shared memory it budgets is the
    kernel's (215,552 bytes at M=8, K=256, one block an SM)."""
    assert cuda_pa.scan_route(Q, M, K, ptr) == route
    assert cuda_pa.scan_smem_bytes(8, 256) == 215_552 <= cuda_pa.SMEM_BYTES
    assert cuda_pa.scan_smem_bytes(16, 256) > cuda_pa.SMEM_BYTES


@pytest.mark.parametrize("Q,n,sms,grid", [(64, 10**6, 132, (4, 33)), (21, 9001, 132, (2, 66)),
                                          (16, 1, 132, (1, 132)), (5000, 10, 132, (313, 1))])
def test_pq_adc_scan_grid_is_persistent(Q, n, sms, grid):
    """One block an SM, each group of 16 queries on its share of them; a
    shape past the grid or the int32 indexing raises before any launch."""
    assert cuda_pa.scan_grid(Q, n, sms) == grid
    for bad in ((64, 2**31 - 10), (2**31 - 10, 5)):
        with pytest.raises(ValueError, match="interleaved kernel's grid"):
            cuda_pa.scan_grid(*bad, sms)
    assert cuda_pa._scan_fn is None and cuda_pa.LAUNCHES["pq_adc"] == 0


@pytest.mark.parametrize("Q,R,n,M,K,W", [
    (2**26, 2**14, 10, 8, 256, 1),     # Q x R pairs past 2^31 - 1 blocks of 256
    (1, 1, 2**31, 8, 256, 1),          # n past int32
    (1, 1, 10, 2**24, 256, 1),         # M * K past int32
    (1, 1, 0, 8, 256, 1),              # an empty table
    (1, 1, 10, 8, 257, 1),             # K past uint8 codes
    (1, 1, 10, 8, 256, 0)])            # no visited words
def test_adc_hop_grid_rejects_what_it_cannot_take(Q, R, n, M, K, W):
    """The ADC wrappers' limits follow the kernels' grid (Q x R pairs, 256 a
    block) and the int32 indexing, and are raised before any launch."""
    with pytest.raises(ValueError, match="hop kernel's grid|unsupported shape"):
        cuda_ga.hop_grid(Q, R, n, M, K, W)
    assert cuda_ga.hop_grid(64, 20, 10**6, 8, 256, 31250) == 5
    assert cuda_ga.hop_grid(2**20, 2**15 - 1, 10, 8, 256, 1) == 2**12 * (2**15 - 1)
    assert cuda_ga._fn is None and cuda_ga.LAUNCHES["gather_adc_masked"] == 0


@pytest.mark.parametrize("Q,R,n,d,blocks", [
    (64, 64, 10**6, 64, 256),          # the rerank
    (64, 10, 10**6, 64, 40),           # a descent step at M = 10
    (64, 1, 10**6, 64, 4),             # a layer start
    (64, 32, 10**6, 64, 128),          # the hubs scan
    (7, 33, 1000, 12289, 15),          # d past the generic kernel's 48 KB query row
    (3, 32 * 65536, 10, 8, 3 * 2 * 65536),  # R past the generic kernel's 65535 tiles
    (0, 5, 10, 8, 0), (1, 1, 1, 1, 1)])
def test_gather_route_sends_every_shape_to_the_pair_kernel(Q, R, n, d, blocks):
    """gather_distance launches the pair kernel at every shape it takes,
    16 pairs a block, the generic kernel's limits on d and R gone; nothing
    is built or counted by the route."""
    assert cuda_gd.gather_route(Q, R, n, d) == ("pairs", blocks)
    assert cuda_gd._pair_fn is None and cuda_gd.LAUNCHES["gather_distance"] == 0


@pytest.mark.parametrize("Q,R,n,d", [
    (2**20, 2**15, 10, 8),             # Q x R pairs past 2^31 - 1 blocks of 16
    (1, 1, 2**31, 8),                  # n past int32
    (1, 1, 10, 2**31),                 # d past int32
    (2**31, 1, 10, 8),                 # Q past int32
    (1, 1, 0, 8),                      # an empty base
    (-1, 1, 10, 8)])
def test_gather_route_rejects_what_the_pair_kernel_cannot_take(Q, R, n, d):
    """The pair kernel's limits are its grid and its int32 indexing, raised
    before any launch; the largest grid it takes is 2^31 - 1 blocks."""
    with pytest.raises(ValueError, match="int32 indexing|unsupported shape"):
        cuda_gd.gather_route(Q, R, n, d)
    assert cuda_gd.pair_grid(2**20, 2**15 - 1, 10, 8) == 2**31 - 2**16
    assert cuda_gd._pair_fn is None


@pytest.mark.parametrize("metric", METRICS)
def test_compressed_plain_versions_match_pallas_interpret(metric):
    """One small shape of each compressed kernel against its Pallas body in
    interpret mode, as tests/test_kernels.py runs them."""
    w = _codes_world(5, 21, 96, 16, 8, 32, seed=7)
    vt = convert.bitmap_from_uint32(w["visited"], "cpu")
    got_d, got_i = ref.gather_sq8_masked_ref(
        _t(w["queries"]), _t(w["ids"], torch.int32), _u8(w["sq_codes"]),
        _t(w["scale"]), _t(w["mn"]), vt, metric)
    want_d, want_i = pallas_gsm(
        jnp.asarray(w["queries"]), jnp.asarray(w["ids"]), jnp.asarray(w["sq_codes"]),
        jnp.asarray(w["scale"]), jnp.asarray(w["mn"]), jnp.asarray(w["visited"]),
        metric=metric, r_tile=8, interpret=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # the Pallas l2 body uses the expanded form: the matrix's tolerance
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **MATRIX_TOL)
    if metric != "l2":
        return  # the ADC kernels are metric-free: the LUT carries the metric
    got_d, got_i = ref.gather_adc_masked_ref(_t(w["ids"], torch.int32),
                                             _u8(w["pq_codes"]), _t(w["luts"]), vt)
    want_d, want_i = pallas_gam(jnp.asarray(w["ids"]), jnp.asarray(w["pq_codes"]),
                                jnp.asarray(w["luts"]), jnp.asarray(w["visited"]),
                                r_tile=8, interpret=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-5)
    got = ref.pq_adc_ref(_u8(w["pq_codes"]), _t(w["luts"][0]))
    want = pallas_pq_adc(jnp.asarray(w["pq_codes"]), jnp.asarray(w["luts"][0]),
                         block_n=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ops_dispatches_cpu_tensors_to_plain_versions():
    queries, base, ids, visited = _world(4, 6, 100, 8)
    qt, it, bt = _t(queries), _t(ids, torch.int32), _t(base)
    vt = convert.bitmap_from_uint32(visited, "cpu")
    before = ops.launch_counts()
    assert torch.equal(ops.gather_distance(qt, it, bt),
                       ref.gather_distance_ref(qt, it, bt))
    for a, b in zip(ops.gather_distance_masked(qt, it, bt, vt, "cos"),
                    ref.gather_distance_masked_ref(qt, it, bt, vt, "cos")):
        assert torch.equal(a, b)
    assert torch.equal(ops.distance_matrix(qt, bt, "ip"),
                       ref.distance_matrix_ref(qt, bt, "ip"))
    w = _codes_world(4, 6, 100, 8, 4, 16)
    it, ct, lt = _t(w["ids"], torch.int32), _u8(w["pq_codes"]), _t(w["luts"])
    vt = convert.bitmap_from_uint32(w["visited"], "cpu")
    sq = (_u8(w["sq_codes"]), _t(w["scale"]), _t(w["mn"]))
    for a, b in zip(ops.gather_sq8_masked(_t(w["queries"]), it, *sq, vt, "ip"),
                    ref.gather_sq8_masked_ref(_t(w["queries"]), it, *sq, vt, "ip")):
        assert torch.equal(a, b)
    for a, b in zip(ops.gather_adc_masked(it, ct, lt, vt),
                    ref.gather_adc_masked_ref(it, ct, lt, vt)):
        assert torch.equal(a, b)
    assert torch.equal(ops.pq_adc(ct, lt), ref.pq_adc_ref(ct, lt))
    q = torch.randn((2, 16, 4, 8))
    assert torch.equal(ops.flash_attention(q, q[:, :, :2], q[:, :, :2], window=4),
                       ref.flash_attention_ref(q, q[:, :, :2], q[:, :, :2], window=4))
    pool = _t(ids, torch.int32)[:, :4].repeat(25, 1)
    assert torch.equal(ops.gather_distance_pool(bt, pool, "cos", chunk=7),
                       ref.gather_distance_pool_ref(bt, pool, "cos"))
    assert ops.launch_counts() == before  # no kernel ran
    assert set(before) == {"gather_distance", "gather_distance_generic", "gather_distance_pool",
                           "gather_distance_masked", "gather_distance_masked_generic",
                           "distance_matrix", "distance_matrix_small",
                           "distance_matrix_tile32", "gather_sq8_masked",
                           "gather_sq8_masked_generic", "gather_adc_masked",
                           "gather_adc_masked_generic", "pq_adc", "pq_adc_generic",
                           "flash_attention", "flash_attention_bwd"}


def test_adc_rejects_codes_past_the_lut():
    """Codes and LUTs must come from one PQ table: a code >= K raises on the
    CPU path, as the CUDA wrappers raise before their kernels index the LUT
    unchecked. K = 256 takes every uint8 code."""
    w = _codes_world(3, 5, 40, 8, 4, 16)
    it, vt = _t(w["ids"], torch.int32), convert.bitmap_from_uint32(w["visited"], "cpu")
    ct, lt = _u8(w["pq_codes"]), _t(w["luts"])
    ct[7, 2] = 16
    with pytest.raises(ValueError, match="past a LUT of K=16"):
        ops.gather_adc_masked(it, ct, lt, vt)
    with pytest.raises(ValueError, match="past a LUT of K=16"):
        ops.pq_adc(ct, lt)
    with pytest.raises(ValueError, match="past a LUT of K=16"):
        ops.pq_adc(ct, lt[0])
    ct[7, 2] = 255
    wide = torch.zeros((3, 4, 256))
    assert ops.pq_adc(ct, wide).shape == (3, 40)
    assert ops.gather_adc_masked(it, ct, wide, vt)[0].shape == (3, 5)


def test_ops_rejects_unsupported_devices():
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.distance_matrix(x, x)


def test_cuda_wrappers_reject_cpu_tensors_before_building():
    """The kernel wrappers take CUDA tensors only: a CPU tensor raises
    before anything is compiled or launched."""
    queries, base, ids, visited = _world(2, 3, 40, 8)
    qt, it, bt = _t(queries), _t(ids, torch.int32), _t(base)
    for gather in (cuda_gd.gather_distance, cuda_gd.gather_distance_generic):
        with pytest.raises(ValueError, match="CUDA tensor"):
            gather(qt, it, bt)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_gd.gather_distance_masked(qt, it, bt,
                                       convert.bitmap_from_uint32(visited, "cpu"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_gd.gather_distance_masked_generic(qt, it, bt,
                                               convert.bitmap_from_uint32(visited, "cpu"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_dm.distance_matrix(qt, bt)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_dm.distance_matrix_tile32(qt, qt)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_gp.gather_distance_pool(bt, _t(np.zeros((40, 3), np.int32), torch.int32))
    w = _codes_world(2, 3, 40, 8, 4, 16)
    it, vt = _t(w["ids"], torch.int32), convert.bitmap_from_uint32(w["visited"], "cpu")
    for sq8 in (cuda_gs.gather_sq8_masked, cuda_gs.gather_sq8_masked_generic):
        with pytest.raises(ValueError, match="CUDA tensor"):
            sq8(_t(w["queries"]), it, _u8(w["sq_codes"]), _t(w["scale"]), _t(w["mn"]), vt)
    for adc in (cuda_ga.gather_adc_masked, cuda_ga.gather_adc_masked_generic):
        with pytest.raises(ValueError, match="CUDA tensor"):
            adc(it, _u8(w["pq_codes"]), _t(w["luts"]), vt)
    for scan in (cuda_pa.pq_adc, cuda_pa.pq_adc_generic):
        with pytest.raises(ValueError, match="CUDA tensor"):
            scan(_u8(w["pq_codes"]), _t(w["luts"]))
    assert all(m._fn is None for m in (cuda_gd, cuda_gp, cuda_dm, cuda_gs, cuda_ga,
                                       cuda_pa))
    assert cuda_gd._hop_fn is None and cuda_gs._hop_fn is None and cuda_dm._small_fn is None
    assert cuda_gd._pair_fn is None
    assert cuda_pa._scan_fn is None


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing compiler is an error, not a quiet switch to the plain
    versions."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(("gather_distance",))


def test_library_path_tracks_source_and_flags(monkeypatch, tmp_path):
    p = _build.library_path("gather_distance")
    assert p == _build.library_path("gather_distance")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libgather_distance-")
    assert p != _build.library_path("distance_matrix")
    assert all((_build.CSRC / f"{s}.cu").exists() for s in _build.SOURCES)
    # an edited shared header changes every library's name: a source that
    # includes it is never loaded stale
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {s: _build.library_path(s) for s in _build.SOURCES}
    assert before["gather_distance"] == p
    header = csrc / "common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {s: _build.library_path(s) for s in _build.SOURCES}
    assert all(after[s] != before[s] for s in _build.SOURCES)
    (csrc / "extra.cuh").write_text("// a new header\n")
    assert _build.library_path("pq_adc") != after["pq_adc"]


def test_bitmap_conversion_round_trips_bit_for_bit():
    words = np.array([[0, 1, 2**31, 2**32 - 1, 0x80000001]], np.uint32)
    t = convert.bitmap_from_uint32(words, "cpu")
    assert t.dtype == torch.int32 and int(t[0, 2]) == -2**31
    np.testing.assert_array_equal(convert.bitmap_to_uint32(t), words)


def _wgmma_flash_arithmetic(q, k, v, causal, window, split_p=True, block=128):
    """The bf16 tensor-core flash kernel's arithmetic (csrc/flash_attention.cu,
    flash_attention_wgmma_kernel) in plain torch on the CPU: bf16 q . k
    summed in fp32, times scale * log2(e) after the product, -1e30 on masked
    scores, the online softmax over 128-key tiles on exp2 with (m, l, acc) in
    fp32, and P . V as two bf16 products, P's hi = bf16(p) and lo = bf16(p -
    hi), summed in fp32 (``split_p=False``: hi alone). ``block`` is the
    kernel's key stage: 128, or 64 where dh or dhv is past 128. Key tiles the kernel
    skips are visited here: for a row that cannot see them they change
    nothing (corr = 1, p = 0). A test helper, not a module of the port."""
    B, S, Hq, dh = q.shape
    G = Hq // k.shape[2]
    c = dh ** -0.5 * math.log2(math.e)
    neg = -1e30
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(G, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, 2).transpose(1, 2)
    m = torch.full((B, Hq, S), neg)
    l = torch.zeros((B, Hq, S))
    acc = torch.zeros((B, Hq, S, v.shape[-1]))
    q_pos = torch.arange(S)[:, None]
    for k0 in range(0, S, block):
        k_pos = torch.arange(k0, min(k0 + block, S))[None, :]
        t = (qf @ kf[:, :, k0:k0 + block].transpose(-1, -2)) * c
        visible = torch.ones((S, k_pos.shape[1]), dtype=torch.bool)
        if causal:
            visible &= k_pos <= q_pos
        if window is not None:
            visible &= q_pos - k_pos < window
        t = t.masked_fill(~visible, neg)
        m_new = torch.maximum(m, t.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.where((m_new == neg)[..., None], 0.0, torch.exp2(t - m_new[..., None]))
        l = l * corr + p.sum(-1)
        hi = p.bfloat16().float()
        tile_v = vf[:, :, k0:k0 + block]
        pv = hi @ tile_v
        if split_p:
            pv = pv + (p - hi).bfloat16().float() @ tile_v
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).transpose(1, 2).bfloat16()


@pytest.mark.parametrize("causal,window", [(True, None), (True, 100), (False, 70)])
@pytest.mark.parametrize("dh", [64, 80, 192, 256])
def test_wgmma_flash_arithmetic_matches_reference(causal, window, dh):
    """The bf16 kernel's split-P arithmetic against the port's plain version,
    the JAX oracle and the JAX Pallas kernel (interpret mode), at FLASH_TOL;
    P rounded to bf16 alone leaves outputs outside it. dh 192 (with dhv
    128, DeepSeek's pair) and 256 run the kernel's 64-key stages."""
    rng = np.random.default_rng(dh + (window or 0))
    B, S, Hq, Hkv = 2, 256, 4, 2
    dhv = 128 if dh == 192 else dh
    block = 64 if max(dh, dhv) > 128 else 128
    q = rng.standard_normal((B, S, Hq, dh), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, dh), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, dhv), dtype=np.float32)
    tq, tk, tv = (_t(a).bfloat16() for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    got = _wgmma_flash_arithmetic(tq, tk, tv, causal, window, block=block).float().numpy()
    wants = {
        "ref.flash_attention_ref": ref.flash_attention_ref(tq, tk, tv, causal, window),
        "jax ref.flash_attention_ref": jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                                                window=window),
        "pallas (interpret)": pallas_fa(jq, jk, jv, causal=causal,
                                        window=window, interpret=True),
    }
    for name, want in wants.items():
        want = want.float().numpy() if isinstance(want, torch.Tensor) else \
            np.asarray(jnp.asarray(want, jnp.float32))
        np.testing.assert_allclose(got, want, **FLASH_BF16_TOL, err_msg=name)
    hi_only = _wgmma_flash_arithmetic(tq, tk, tv, causal, window, split_p=False, block=block)
    want = wants["ref.flash_attention_ref"].float()
    outside = (hi_only.float() - want).abs() > (FLASH_BF16_TOL["atol"]
                                                + FLASH_BF16_TOL["rtol"] * want.abs())
    assert int(outside.sum()) > 0


def test_tma_operands_are_read_in_place_or_copied():
    """The bf16 wrapper's TMA rule on the CPU: (B, S, H, d) layouts and a
    fused projection's views are read in place; a transposed layout, a row
    of 5 bf16 (10 bytes) and a misaligned base are copied into rows padded
    to 8 elements, with the same values."""
    fused = torch.randn((2, 130, 4, 96)).bfloat16()
    assert cuda_fa._tma_strides(fused[..., 32:64]) == (49920, 384, 96)
    assert cuda_fa._tma_strides(torch.randn((1, 1, 1, 64)).bfloat16()) == (64, 64, 64)
    for t in (torch.randn((2, 4, 130, 64)).bfloat16().transpose(1, 2),
              torch.randn((2, 70, 2, 5)).bfloat16(),
              torch.randn((2 * 70 * 2 * 32 + 1,)).bfloat16()[1:].view(2, 70, 2, 32)):
        assert cuda_fa._tma_strides(t) is None
        copy, strides = cuda_fa._tma_operand(t)
        assert torch.equal(copy, t) and strides == copy.stride()[:3]
        assert strides[2] % 8 == 0 and copy.data_ptr() % 16 == 0


def test_no_jax_or_repro_in_the_port():
    """Importing every module of the port pulls in neither jax nor repro."""
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert len(mods) >= 25, mods\n"
        "assert {'repro_torch.baselines.pq', 'repro_torch.kernels.gather_sq8',\n"
        "        'repro_torch.kernels.gather_distance_pool',\n"
        "        'repro_torch.kernels.gather_adc', 'repro_torch.kernels.pq_adc',\n"
        "        'repro_torch.kernels.flash_attention', 'repro_torch.models.transformer'\n"
        "        } <= set(mods)\n"
        "assert not bad, bad\n"
    )
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": src},
                         timeout=120)
    assert res.returncode == 0, res.stderr
