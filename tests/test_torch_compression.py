"""The port's gradient compression (``distributed/compression.py``) on the
CPU against the reference's, on one-rank and two-rank gloo groups.

The stochastic rounding's noise is an input: fed the reference's own
``jax.random`` draws, the port's int8 quantizer and its one-rank
``compressed_psum_int8`` give the reference's values bit for bit.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_compression_worker as worker
from jax.sharding import PartitionSpec as P

from repro.distributed import compression as jc
from repro.distributed._compat import shard_map
from repro.launch.mesh import make_test_mesh
from repro_torch.distributed import compression as pc
from repro_torch.launch.mesh import make_flat_group

SPAWN_TIMEOUT_S = 60


def _noise(key, shape):
    return jax.random.uniform(key, shape, minval=-0.5, maxval=0.5)


def test_int8_on_the_reference_noise_is_bit_identical():
    x = jax.random.normal(jax.random.PRNGKey(0), (1000,))
    key = jax.random.PRNGKey(1)
    jq, js = jc.quantize_int8(x, key)
    q, s = pc.quantize_int8(torch.from_numpy(np.asarray(x)),
                            torch.from_numpy(np.asarray(_noise(key, x.shape))))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(pc.dequantize_int8(q, s).numpy(),
                                  np.asarray(jc.dequantize_int8(jq, js)))


def test_int8_error_is_bounded_by_the_scale():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1000,), generator=gen)
    q, s = pc.quantize_int8(x, pc.int8_noise(gen, x))
    err = (pc.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 1.01
    noise = pc.int8_noise(gen, x)
    assert float(noise.min()) >= -0.5 and float(noise.max()) < 0.5


def test_topk_error_feedback_matches_the_reference():
    """Distinct magnitudes (normal draws: no ties), 40 rounds of compress +
    residual."""
    x = np.random.default_rng(2).standard_normal(256).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jef, tef = jc.ef_init(jx), pc.ef_init(tx)
    jsent, tsent = jnp.zeros_like(jx), torch.zeros_like(tx)
    for _ in range(40):
        jcor, tcor = jx + jef.residual, tx + tef.residual
        jv, ji = jc.topk_compress(jcor, 16)
        tv, ti = pc.topk_compress(tcor, 16)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        jd, td = jc.topk_decompress(jv, ji, 256), pc.topk_decompress(tv, ti, 256)
        jef, tef = jc.EFState(residual=jcor - jd), pc.EFState(residual=tcor - td)
        jsent, tsent = jsent + jd, tsent + td
    np.testing.assert_array_equal(tsent.numpy(), np.asarray(jsent))
    cos = torch.sum(tsent * tx) / (tsent.norm() * tx.norm())
    assert float(cos) > 0.98


@pytest.fixture(scope="module")
def one_rank_group():
    return make_flat_group("cpu").group


def test_one_rank_psums_equal_the_reference(one_rank_group):
    mesh = make_test_mesh((1, 1))
    x = jax.random.normal(jax.random.PRNGKey(3), (8, 4))
    key = jax.random.PRNGKey(4)
    data = mesh.axis_names[0]
    want = jax.jit(shard_map(lambda v, k: jc.compressed_psum_int8(v, k[0], data), mesh=mesh,
                             in_specs=(P(), P()), out_specs=P()))(x, key[None])
    noise = torch.from_numpy(np.asarray(_noise(key, x.shape)))
    got = pc.compressed_psum_int8(torch.from_numpy(np.asarray(x)), noise, one_rank_group)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jdense, jef = jax.jit(shard_map(lambda v: jc.compressed_psum_topk(v, jc.ef_init(v), 5, data),
                                    mesh=mesh, in_specs=(P(),), out_specs=(P(), P())))(x)
    avg, new_ef = pc.compressed_psum_topk(torch.from_numpy(np.asarray(x)),
                                          pc.ef_init(torch.from_numpy(np.asarray(x))), 5,
                                          one_rank_group)
    np.testing.assert_array_equal(avg.numpy(), np.asarray(jdense))
    np.testing.assert_array_equal(new_ef.residual.numpy(), np.asarray(jef.residual))
    allreduce = pc.make_compressed_allreduce(one_rank_group, scheme="int8")
    g = {"w": torch.from_numpy(np.asarray(x)), "b": torch.ones(3, dtype=torch.bfloat16)}
    out = allreduce(g, torch.Generator().manual_seed(0))
    assert out["b"].dtype == torch.bfloat16
    torch.testing.assert_close(out["w"], g["w"], atol=0.05, rtol=0)
    plain = pc.make_compressed_allreduce(one_rank_group, scheme="none")(g, None)
    assert torch.equal(plain["w"], g["w"])


def test_two_rank_int8_psum_is_the_mean_of_the_quantized_contributions(tmp_path):
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((2, 64)).astype(np.float32)
    noises = rng.uniform(-0.5, 0.5, size=(2, 64)).astype(np.float32)
    ctx = mp.get_context("spawn")
    before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [ctx.Process(target=worker.run_rank,
                             args=(r, 2, str(tmp_path / "store"), xs, noises, str(tmp_path)))
                 for r in range(2)]
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
    assert not hung, f"ranks {hung} did not finish in {SPAWN_TIMEOUT_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    got = [np.load(tmp_path / f"rank{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(got[0], got[1])
    scale = np.float32(max(np.abs(xs).max(), 1e-12)) / np.float32(127.0)
    q = np.clip(np.round(xs / scale + noises), -127, 127).astype(np.int32)
    want = q.sum(0).astype(np.float32) * scale / np.float32(2.0)
    np.testing.assert_allclose(got[0], want, rtol=0, atol=1e-7)
    assert np.abs(got[0] - xs.mean(0)).max() <= float(scale)


def test_allreduce_over_a_mesh_takes_its_first_data_axis(one_rank_group):
    """On a DeviceMesh the reduction runs over ``data_axes(mesh)[0]``'s
    group, the reference's rule; on make_test_mesh((1, 1)) against the
    reference's call on its (1, 1) mesh, same gradients: the plain mean bit
    for bit, int8 within one quantization step (each side draws its own
    rounding noise)."""
    from repro_torch.launch.mesh import make_test_mesh as port_test_mesh

    mesh = port_test_mesh((1, 1), device_type="cpu")
    x = jax.random.normal(jax.random.PRNGKey(5), (16, 8))
    g = {"w": torch.from_numpy(np.asarray(x))}
    jmesh = make_test_mesh((1, 1))
    want = jc.make_compressed_allreduce(jmesh, scheme="none")({"w": x}, jax.random.PRNGKey(6))
    got = pc.make_compressed_allreduce(mesh, scheme="none")(g, None)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    jint8 = jc.make_compressed_allreduce(jmesh, scheme="int8")({"w": x}, jax.random.PRNGKey(6))
    int8 = pc.make_compressed_allreduce(mesh, scheme="int8")(g, torch.Generator().manual_seed(6))
    step = float(np.abs(np.asarray(x)).max()) / 127.0
    assert float(np.abs(int8["w"].numpy() - np.asarray(jint8["w"])).max()) <= step * 1.0001
