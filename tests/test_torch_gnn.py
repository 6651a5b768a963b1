"""The port's GraphSAGE on the CPU against live calls into repro: the
config and its cells, the full-graph forward under each aggregator, the
dense (molecule) forward, the neighbor sampler and the minibatch forward
given the reference's draws, the full-graph loss and its gradients, the SBM
graph from the reference's draws, the CSR build, and ``edges_from_knn``.

Tolerances: logits and losses within rtol 1e-5, atol 1e-5 (fp32 sums in
another order; the full-graph aggregate sums a node's messages in edge
order, as the reference's ``segment_sum`` does on the CPU); gradients
within 1e-5 of each leaf's max-abs. Sampled ids, the SBM graph and the CSR
are bit-identical. ``edges_from_knn`` draws from another generator than the
reference's NN-Descent, so its graph-recall proxy (the share of each
point's exact k nearest neighbors among its edges) is held within 0.03 of
the reference's on the same points at k=12 (the reference fails below 12).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import graphsage_reddit as j_sage
from repro.core import bruteforce as jbrute
from repro.data import synthetic as jsyn
from repro.models import gnn as JG
from repro_torch import configs
from repro_torch.data import synthetic
from repro_torch.models import convert, gnn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
RECALL_SLACK = 0.03


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(cfg_j, seed=0):
    jp = JG.init_params(jax.random.PRNGKey(seed), cfg_j)
    cfg = gnn.SAGEConfig(**{f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)
                            if f.name != "dtype"})
    return jp, convert.sage_params_from_numpy(jax.tree.map(np.array, jp), cfg, "cpu")


@pytest.fixture(scope="module")
def graph():
    """An SBM graph of the reference (n=300, 4 classes, d=16, avg_deg 6)
    with nodes 7 and 299 (the last) given no edge at all."""
    g = jsyn.sbm_graph(jax.random.PRNGKey(3), 300, 4, 16, avg_deg=6)
    edges = np.asarray(g["edges"])
    edges = edges[~np.isin(edges, [7, 299]).any(axis=1)]
    return np.asarray(g["feats"]), edges, np.asarray(g["labels"])


def test_port_config_copies_the_reference():
    ad, jad = configs.get_arch("graphsage-reddit"), j_get_arch("graphsage-reddit")
    assert (ad.family, ad.optimizer) == (jad.family, jad.optimizer) == ("gnn", "adamw")
    for mine, theirs in ((ad.model_cfg, j_sage.CONFIG), (ad.smoke_cfg, j_sage.SMOKE)):
        a, b = dataclasses.asdict(mine), dataclasses.asdict(theirs)
        assert a.pop("dtype") == torch.float32 and b.pop("dtype") == jnp.float32
        assert a == b
    assert [dataclasses.astuple(c) for c in ad.cells()] == \
        [dataclasses.astuple(c) for c in jad.cells()]
    # the reference's per-cell rule (configs/common.py): d_in from the cell,
    # the fanouts kept
    for shape in configs.GNN_SHAPES:
        cfg = configs.cell_config(ad, shape)
        assert cfg.d_in == configs.GNN_SHAPES[shape]["d_feat"]
        assert cfg.fanouts == ad.model_cfg.fanouts == (25, 10)
        assert dataclasses.replace(cfg, d_in=602) == ad.model_cfg


@pytest.mark.parametrize("aggregator", ["mean", "sum", "max"])
def test_forward_full_matches_reference(graph, aggregator):
    feats, edges, _ = graph
    jcfg = dataclasses.replace(j_sage.SMOKE, aggregator=aggregator)
    jp, model = _models(jcfg, seed=1)
    want = JG.forward_full(jp, jnp.asarray(feats), jnp.asarray(edges), jcfg)
    got = gnn.forward_full(model, _t(feats), _t(edges))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    agg = gnn.aggregate(_t(feats), _t(edges), feats.shape[0], aggregator)
    assert (agg[[7, 299]] == 0).all()                 # no in-edge: 0 in every mode


def test_forward_dense_matches_reference():
    jcfg = dataclasses.replace(j_sage.SMOKE, d_in=5)
    jp, model = _models(jcfg, seed=2)
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((6, 9, 5), dtype=np.float32)
    adj = (rng.random((6, 9, 9)) < 0.3).astype(np.float32)
    adj[0, 3] = 0                                     # a node with no neighbor
    want = JG.forward_dense(jp, jnp.asarray(feats), jnp.asarray(adj), jcfg)
    got = gnn.forward_dense(model, _t(feats), _t(adj))
    assert got.shape == (6, jcfg.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _csr(edges, n):
    indptr, indices = jsyn.edges_to_csr(edges, n)
    return np.asarray(indptr), np.asarray(indices)


def test_sample_neighbors_on_the_reference_draws_matches_reference(graph):
    _, edges, _ = graph
    indptr, indices = _csr(edges, 300)
    nodes = np.array([0, 7, 299, 5, 150, 7, 298], np.int32)   # 7 and 299 isolated
    key = jax.random.PRNGKey(8)
    want = np.asarray(JG.sample_neighbors(key, jnp.asarray(indptr), jnp.asarray(indices),
                                          jnp.asarray(nodes), 5))
    draws = jax.random.randint(key, (len(nodes), 5), 0, jnp.iinfo(jnp.int32).max)
    got = gnn.sample_neighbors(_t(draws), _t(indptr), _t(indices), _t(nodes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[1] == 7).all() and (want[2] == 299).all()


@pytest.mark.parametrize("aggregator", ["mean", "max"])
def test_forward_minibatch_on_the_reference_draws_matches_reference(graph, aggregator):
    feats, edges, _ = graph
    indptr, indices = _csr(edges, 300)
    jcfg = dataclasses.replace(j_sage.SMOKE, aggregator=aggregator)
    jp, model = _models(jcfg, seed=5)
    nodes = np.array([1, 7, 42, 299, 100, 250], np.int32)
    key = jax.random.PRNGKey(9)
    want = JG.forward_minibatch(jp, key, jnp.asarray(feats), jnp.asarray(indptr),
                                jnp.asarray(indices), jnp.asarray(nodes), jcfg)
    draws, k, size = [], key, len(nodes)
    for fan in jcfg.fanouts:                          # the reference's key schedule
        k, kk = jax.random.split(k)
        draws.append(_t(jax.random.randint(kk, (size, fan), 0, jnp.iinfo(jnp.int32).max)))
        size *= fan
    got = gnn.forward_minibatch(model, _t(feats), _t(indptr), _t(indices), _t(nodes),
                                draws=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    own = gnn.forward_minibatch(model, _t(feats), _t(indptr), _t(indices), _t(nodes),
                                generator=torch.Generator().manual_seed(0))
    assert own.shape == (6, jcfg.n_classes) and bool(torch.isfinite(own).all())


def test_loss_full_and_gradients_match_reference(graph):
    feats, edges, labels = graph
    jp, model = _models(j_sage.SMOKE, seed=6)
    mask = (np.random.default_rng(7).random(300) < 0.5).astype(np.float32)
    loss_w, grads_w = jax.value_and_grad(JG.loss_full)(
        jp, jnp.asarray(feats), jnp.asarray(edges), jnp.asarray(labels), jnp.asarray(mask),
        j_sage.SMOKE)
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss = gnn.loss_full(model, _t(feats), _t(edges), _t(labels), _t(mask))
    np.testing.assert_allclose(float(loss.detach()), float(loss_w), **TOL)
    want = convert._flatten(jax.tree.map(np.array, grads_w))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert set(grads) == set(want)
    for name, g in grads.items():
        scale = max(float(np.abs(want[name]).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def test_init_params_and_converter():
    cfg = configs.get_arch("graphsage-reddit").smoke_cfg
    a, b = gnn.init_params(cfg, 0, "cpu"), gnn.init_params(cfg, 0, "cpu")
    names = {n for n, _ in a.named_parameters()}
    assert names == {"layers.0.w_self", "layers.0.w_nbr", "layers.1.w_self", "layers.1.w_nbr",
                     "head"}
    for (_, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q) and not p.requires_grad
    big = gnn.init_params(dataclasses.replace(cfg, d_in=400, d_hidden=300), 1, "cpu")
    assert abs(float(big.layers[0].w_self.std()) * 400 ** 0.5 - 1) < 0.05
    tree = jax.tree.map(np.array, JG.init_params(jax.random.PRNGKey(0), j_sage.SMOKE))
    tree["layers"][1]["w_nbr"] = tree["layers"][1]["w_nbr"][:, :-1]
    with pytest.raises(ValueError, match="layers.1.w_nbr"):
        convert.sage_params_from_numpy(tree, cfg, "cpu")
    del tree["head"]
    with pytest.raises(ValueError, match=r"missing \['head'\]"):
        convert.sage_params_from_numpy(tree, cfg, "cpu")


# -- graphs ------------------------------------------------------------------------


def test_sbm_graph_on_the_reference_draws_is_the_reference_graph():
    key = jax.random.PRNGKey(11)
    n, C, d, deg = 500, 5, 12, 7
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = (jax.random.randint(k1, (n,), 0, C), jax.random.randint(k2, (n * deg,), 0, n),
             jax.random.randint(k3, (n * deg,), 0, n), jax.random.uniform(k4, (n * deg,)),
             jax.random.normal(jax.random.fold_in(k1, 1), (C, d)),
             jax.random.normal(jax.random.fold_in(k1, 2), (n, d)))
    got = synthetic.sbm_from_draws(*(_t(x) for x in draws))
    want = jsyn.sbm_graph(key, n, C, d, avg_deg=deg)
    for name in ("feats", "edges", "labels"):
        assert got[name].numpy().dtype == np.asarray(want[name]).dtype
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    own = synthetic.sbm_graph(torch.Generator().manual_seed(0), n, C, d, avg_deg=deg)
    e = own["edges"].long()
    assert e.shape == (n * deg, 2) and own["feats"].shape == (n, d)
    lab = own["labels"].long()
    homophily = float((lab[e[:, 0]] == lab[e[:, 1]]).float().mean())
    assert homophily > 0.6                  # same-class kept always, others at 0.1


@pytest.mark.parametrize("n", [1, 50, 300])
def test_edges_to_csr_is_the_reference_csr(n):
    rng = np.random.default_rng(n)
    edges = rng.integers(0, n, (7 * n, 2)).astype(np.int32)
    edges[: n // 3, 0] = n - 1                        # repeated sources keep edge order
    want = jsyn.edges_to_csr(edges, n)
    got = synthetic.edges_to_csr(_t(edges), n)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


def _knn_recall(edges, exact, k):
    nbrs = edges[:, 1].reshape(-1, k)
    return float(np.mean([len(set(nbrs[v]) & set(exact[v])) / k for v in range(len(exact))]))


def test_edges_from_knn_recall_is_within_slack_of_the_reference():
    """At k=12 against the reference's edges; at the default k=8 the port's
    sample is cut to k (the reference's NN-Descent samples 12 of a vertex's k
    neighbors and fails below k=12, ROADMAP queue C), held by its recall."""
    g = jsyn.sbm_graph(jax.random.PRNGKey(12), 1500, 6, 24, avg_deg=2)
    pts = np.asarray(g["feats"])
    for k in (12, 8):
        exact = np.asarray(jbrute.exact_knn_graph(jnp.asarray(pts), k).neighbors)
        got = gnn.edges_from_knn(_t(pts), k=k)
        assert got.shape == (1500 * k, 2) and got.dtype == torch.int32
        np.testing.assert_array_equal(got[:, 0].numpy(), np.repeat(np.arange(1500), k))
        r_got = _knn_recall(got.numpy(), exact, k)
        assert r_got > 0.8, (k, r_got)
        if k == 12:
            want = np.asarray(JG.edges_from_knn(jnp.asarray(pts), k=k))
            r_want = _knn_recall(want, exact, k)
            assert abs(r_got - r_want) <= RECALL_SLACK, (r_got, r_want)
    with pytest.raises(ValueError, match="broadcast"):
        JG.edges_from_knn(jnp.asarray(pts), k=8)
