"""The paper's datasets, experiment configs and metric layer on the port,
held against live calls into ``repro`` on the CPU.

The tables (``PAPER_DATASETS``, ``ALL_EXPERIMENTS``) are equal field for
field. The manifold lift given the same numpy draws agrees with the
reference's formula to 1e-5. The draws themselves come from a
``torch.Generator``, so each dataset is held by its law: the LID estimate
at scale 0.002 within max(1.0, 8%) of the reference's at the same scale.
The metric layer agrees to rtol/atol 1e-5, zero rows and the clamp at 0
included.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ann_paper as jcfg
from repro.core import distances as jdist
from repro.core import lid as jlid
from repro.data import synthetic as jsyn
from repro_torch.configs import ann_paper
from repro_torch.core import distances, lid
from repro_torch.data import synthetic
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
LID_SCALE = 0.002


def test_paper_datasets_are_the_references():
    assert synthetic.PAPER_DATASETS == jsyn.PAPER_DATASETS


def test_all_experiments_are_the_references():
    assert list(ann_paper.ALL_EXPERIMENTS) == list(jcfg.ALL_EXPERIMENTS)
    for name, cfg in ann_paper.ALL_EXPERIMENTS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg.ALL_EXPERIMENTS[name])
    assert ([f.name for f in dataclasses.fields(ann_paper.AnnExperimentConfig)]
            == [f.name for f in dataclasses.fields(jcfg.AnnExperimentConfig)])


@pytest.mark.parametrize("latent,d", [(16, 128), (38, 960), (40, 100)])
def test_manifold_lift_matches_the_references_formula(latent, d):
    """The reference's lift, tanh(z @ w1) @ w2 + noise * eps, on the same
    numpy draws."""
    rng = np.random.default_rng(latent)
    n = 300
    z = rng.uniform(size=(n, latent)).astype(np.float32)
    w1 = (rng.standard_normal((latent, 2 * latent)) / np.sqrt(latent)).astype(np.float32)
    w2 = (rng.standard_normal((2 * latent, d)) / np.sqrt(2 * latent)).astype(np.float32)
    eps = rng.standard_normal((n, d)).astype(np.float32)
    want = jnp.tanh(jnp.asarray(z) @ jnp.asarray(w1)) @ jnp.asarray(w2) + 0.01 * jnp.asarray(eps)
    got = synthetic.manifold_lift(*(torch.from_numpy(a) for a in (z, w1, w2, eps)), 0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", list(jsyn.PAPER_DATASETS))
def test_dataset_lid_matches_the_reference(name):
    """tab1's estimate (k=20, 1,500 sampled points) at scale 0.002: the
    port's world within max(1.0, 8%) of the reference's (jax.random key 0;
    the reference's own spread over keys 0 and 1 is at most 0.61)."""
    jbase, _, _ = jsyn.make_ann_dataset(name, key=jax.random.PRNGKey(0), scale=LID_SCALE,
                                        n_queries=16)
    want = float(jlid.lid_mle(jbase, k=20, sample=min(1500, jbase.shape[0]), metric="l2"))
    base, queries, metric = synthetic.make_ann_dataset(name, scale=LID_SCALE, n_queries=16,
                                                       device="cpu")
    spec = synthetic.PAPER_DATASETS[name]
    assert base.shape == tuple(jbase.shape) and queries.shape == (16, spec["d"])
    assert metric == spec["metric"] and base.dtype == torch.float32
    assert torch.isfinite(base).all()
    got = lid.lid_mle(base, k=20, sample=min(1500, base.shape[0]), metric="l2")
    assert abs(got - want) <= max(1.0, 0.08 * want), (got, want)


def test_rand_dataset_is_uniform_on_the_unit_cube():
    base, queries, _ = synthetic.make_ann_dataset("RAND10M8D", scale=1e-4, n_queries=50,
                                                  device="cpu")
    assert base.shape == (1000, 8) and queries.shape == (50, 8)
    assert float(base.min()) >= 0.0 and float(base.max()) < 1.0
    assert abs(float(base.mean()) - 0.5) < 0.02


def test_datasets_are_seeded():
    a, qa, _ = synthetic.make_ann_dataset("SIFT1M", seed=3, scale=1e-3, n_queries=8, device="cpu")
    b, qb, _ = synthetic.make_ann_dataset("SIFT1M", seed=3, scale=1e-3, n_queries=8, device="cpu")
    c, _, _ = synthetic.make_ann_dataset("SIFT1M", seed=4, scale=1e-3, n_queries=8, device="cpu")
    assert torch.equal(a, b) and torch.equal(qa, qb) and not torch.equal(a, c)
    assert synthetic.default_seed("SIFT1M") != synthetic.default_seed("GIST1M")


def test_default_world_does_not_depend_on_the_hash_seed():
    """The reference keys its default world on hash(name), which Python
    salts per process; the port's default seed is crc32 of the name, so two
    processes with different PYTHONHASHSEED draw the same base. Each child
    runs one OpenMP thread, so it does not contend with the test workers
    for cores; its time limit allows for a loaded machine."""
    code = ("import torch; from repro_torch.data.synthetic import make_ann_dataset; "
            "b, q, _ = make_ann_dataset('GLOVE1M', scale=1e-3, n_queries=4, device='cpu'); "
            "print(repr(float(b.double().sum())), repr(float(q.double().sum())))")
    outs = []
    for hash_seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=hash_seed, OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT / "src"))
        res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                             text=True, timeout=600, cwd=ROOT)
        assert res.returncode == 0, (hash_seed, res.returncode, res.stderr[-4000:])
        lines = res.stdout.strip().splitlines()
        assert lines, (hash_seed, res.stdout, res.stderr[-4000:])
        outs.append(lines[-1])
    assert outs[0] == outs[1], outs


def _rows(seed, n, d, zero_row=None):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    if zero_row is not None:
        x[zero_row] = 0.0
    return x


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_pairwise_matches_the_reference(metric):
    """(n, m) matrices with a zero row on each side and 30 rows shared
    (pairs at distance 0: the l2 clamp at 0)."""
    x = _rows(0, 37, 24, zero_row=3)
    y = _rows(1, 51, 24, zero_row=-1)
    y[10:40] = x[:30]
    fns = {"l2": (distances.pairwise_l2, jdist.pairwise_l2),
           "ip": (distances.pairwise_ip, jdist.pairwise_ip),
           "cos": (distances.pairwise_cos, jdist.pairwise_cos)}[metric]
    want = np.asarray(jdist.pairwise(jnp.asarray(x), jnp.asarray(y), metric))
    got = distances.pairwise(torch.from_numpy(x), torch.from_numpy(y), metric).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(fns[0](torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(fns[1](jnp.asarray(x), jnp.asarray(y))), **TOL)
    if metric == "l2":
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        raw = (xt * xt).sum(-1)[:, None] - 2.0 * (xt @ yt.T) + (yt * yt).sum(-1)[None, :]
        assert (raw < 0).any() and (got[raw.numpy() < 0] == 0.0).all() and (got >= 0).all()
    if metric == "cos":   # the zero row's norm clamps at 1e-6: distance 1
        np.testing.assert_allclose(got[3], 1.0, **TOL)
    pp = distances.point_to_points(torch.from_numpy(x[2]), torch.from_numpy(y), metric)
    np.testing.assert_allclose(pp.numpy(), np.asarray(
        jdist.point_to_points(jnp.asarray(x[2]), jnp.asarray(y), metric)), **TOL)
    for i, j in ((0, 0), (3, 4), (7, 5)):
        got_d = float(distances.distance(torch.from_numpy(x[i]), torch.from_numpy(y[j]), metric))
        want_d = float(jdist.distance(jnp.asarray(x[i]), jnp.asarray(y[j]), metric))
        assert got_d == pytest.approx(want_d, rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_report_scale_matches_the_reference(metric):
    d = np.array([[-1e-7, 0.0, 0.25, 4.0, 1e6], [2.0, -3.0, 0.5, 9.0, 0.0]], np.float32)
    want = np.asarray(jdist.report_scale(jnp.asarray(d), metric))
    got = distances.report_scale(torch.from_numpy(d), metric).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert distances.METRICS == jdist.METRICS
