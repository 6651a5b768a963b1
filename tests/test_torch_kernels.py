"""The port's kernels: plain versions against ``repro.kernels.ref`` (and the
Pallas bodies in interpret mode) on the CPU, plus dispatch and wrapper
checks. Each CUDA kernel against its plain version, on a GPU, is in
tests/test_torch_cuda.py.

Inputs are made with numpy from a seed; JAX stays on the CPU and data
crosses between the two as numpy.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import distance_matrix as pallas_dm
from repro.kernels import gather_distance as pallas_gd
from repro.kernels import gather_distance_masked as pallas_gdm
from repro.kernels import ref as jref
from repro_torch.core import convert
from repro_torch.kernels import _build, ops
from repro_torch.kernels import distance_matrix as cuda_dm
from repro_torch.kernels import gather_distance as cuda_gd
from repro_torch.kernels import ref
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

METRICS = ["l2", "ip", "cos"]
# the plain gathers compute the same diff-form / rsqrt formulas as the
# reference in float32; only the summation order may differ
GATHER_TOL = dict(rtol=1e-5, atol=1e-5)
# the matrix's expanded l2 form cancels, so its error scales with the norms
MATRIX_TOL = dict(rtol=1e-5, atol=1e-4)


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
    assert ops.launch_counts() == before  # no kernel ran


def test_ops_rejects_unsupported_devices():
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.distance_matrix(x, x)


def test_cuda_wrappers_reject_cpu_tensors_before_building():
    """The kernel wrappers take CUDA tensors only: a CPU tensor raises
    before anything is compiled or launched."""
    queries, base, ids, visited = _world(2, 3, 40, 8)
    qt, it, bt = _t(queries), _t(ids, torch.int32), _t(base)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_gd.gather_distance(qt, it, bt)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_gd.gather_distance_masked(qt, it, bt,
                                       convert.bitmap_from_uint32(visited, "cpu"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_dm.distance_matrix(qt, bt)
    assert cuda_gd._fn is None and cuda_dm._fn is None


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing compiler is an error, not a quiet switch to the plain
    versions."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(("gather_distance",))


def test_library_path_tracks_source_and_flags():
    p = _build.library_path("gather_distance")
    assert p == _build.library_path("gather_distance")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libgather_distance-")
    assert p != _build.library_path("distance_matrix")
    assert all((_build.CSRC / f"{s}.cu").exists() for s in _build.SOURCES)


def test_bitmap_conversion_round_trips_bit_for_bit():
    words = np.array([[0, 1, 2**31, 2**32 - 1, 0x80000001]], np.uint32)
    t = convert.bitmap_from_uint32(words, "cpu")
    assert t.dtype == torch.int32 and int(t[0, 2]) == -2**31
    np.testing.assert_array_equal(convert.bitmap_to_uint32(t), words)


def test_no_jax_or_repro_in_the_port():
    """Importing every module of the port pulls in neither jax nor repro."""
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert len(mods) >= 18, mods\n"
        "assert not bad, bad\n"
    )
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": src},
                         timeout=120)
    assert res.returncode == 0, res.stderr
