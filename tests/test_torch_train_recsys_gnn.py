"""The port's recsys and GNN train steps (``configs.common.cell_train_step``)
on the CPU against the reference's own: the ``step`` of
``repro.configs.common.build_lowerable`` for each train cell at its smoke
config (``dataclasses.replace(ad, model_cfg=ad.smoke_cfg)``), under
``jax.jit``, called on small batches; the nine steps are DLRM (dense and
with ``extra={"sparse_emb_update": True}``), DeepFM, AutoInt, BERT4Rec and
GraphSAGE's full_graph_sm, minibatch_lg, ogb_products and molecule. Both
sides start from the reference's weights (carried across by
``models/convert.py``) with zero optimizer state, and take the same numpy
batches from a seed; the minibatch draws are the reference's key splits.

Tolerances, over 3 steps: each step's loss within rtol 1e-5; every
parameter after step 3 within 1e-5 of its own max-abs (fp32 sums in
another order; AdamW's ``m / (sqrt(v) + eps)`` is a sign where a gradient
is far above eps, so it carries no such difference further). The sparse
step's table rows no id touched stay bit-identical, and no table gets a
``.grad``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.configs import get_arch as j_get_arch
from repro.launch.mesh import make_test_mesh
from repro.models import gnn as JG
from repro.models import recsys as JR
from repro_torch import configs
from repro_torch.models import convert
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5
STEPS = 3
JINIT = {"dlrm-mlperf": JR.dlrm_init, "deepfm": JR.deepfm_init, "autoint": JR.autoint_init,
         "bert4rec": JR.bert4rec_init}
CASES = [("dlrm-mlperf", "train_batch", False), ("dlrm-mlperf", "train_batch", True),
         ("deepfm", "train_batch", False), ("autoint", "train_batch", False),
         ("bert4rec", "train_batch", False), ("graphsage-reddit", "full_graph_sm", False),
         ("graphsage-reddit", "minibatch_lg", False), ("graphsage-reddit", "ogb_products", False),
         ("graphsage-reddit", "molecule", False)]
IDS = ["dlrm", "dlrm-sparse", "deepfm", "autoint", "bert4rec", "full_graph_sm",
       "minibatch_lg", "ogb_products", "molecule"]


def _smoke(ad, sparse: bool):
    return dataclasses.replace(ad, model_cfg=ad.smoke_cfg,
                               extra={"sparse_emb_update": True} if sparse else {})


def _recsys_batch(rng, cfg) -> dict:
    """B = 48 rows; each field's ids from the first 12 of its rows, so ids
    repeat within a field and most rows go untouched."""
    B, F = 48, len(cfg.vocab_sizes)
    out = {"sparse": rng.integers(0, 12, (B, F)).astype(np.int32),
           "label": (rng.random(B) < 0.4).astype(np.float32)}
    if hasattr(cfg, "n_dense"):
        out["dense"] = rng.standard_normal((B, cfg.n_dense), dtype=np.float32)
    return out


def _bert4rec_batch(rng, cfg, unused: bool = True) -> dict:
    """Markov sequences with a fixed count of distinct cloze positions a
    row, two slots unused (-100) where ``unused``."""
    B, S, M = 6, cfg.seq_len, 4
    seqs = (rng.integers(0, cfg.n_items, (B, 1)) + rng.integers(1, 7, (B, 1))
            * np.arange(S)[None]) % cfg.n_items
    pos = np.stack([rng.choice(S, M, replace=False) for _ in range(B)])
    labels = np.take_along_axis(seqs, pos, 1)
    items = seqs.copy()
    np.put_along_axis(items, pos, cfg.mask_token, 1)
    if unused:
        labels[0, :2] = -100
    return {"items": items.astype(np.int32), "masked_pos": pos.astype(np.int32),
            "labels": labels.astype(np.int32)}


def _gnn_batch(rng, shape: str, n_classes: int):
    """(reference batch, port batch): a graph of 150 nodes at the cell's
    d_feat; minibatch_lg its CSR, 10 nodes and the reference's key (the
    port takes that key's draws); molecule 8 graphs of 30 nodes."""
    d = configs.GNN_SHAPES[shape]["d_feat"]
    if shape == "molecule":
        b = {"feats": rng.standard_normal((8, 30, d), dtype=np.float32),
             "adj": (rng.random((8, 30, 30)) < 0.1).astype(np.float32),
             "labels": rng.integers(0, n_classes, 8).astype(np.int32)}
        return b, b
    N, E = 150, 900
    feats = rng.standard_normal((N, d), dtype=np.float32)
    edges = rng.integers(0, N, (E, 2)).astype(np.int32)
    labels = rng.integers(0, n_classes, N).astype(np.int32)
    if shape != "minibatch_lg":
        b = {"feats": feats, "edges": edges, "labels": labels,
             "mask": (rng.random(N) < 0.5).astype(np.float32)}
        return b, b
    order = np.argsort(edges[:, 0], kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(edges[:, 0], minlength=N))])
    nodes = rng.choice(N, 10, replace=False).astype(np.int32)
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    jb = {"key": key, "feats": feats, "indptr": indptr.astype(np.int32),
          "indices": edges[order, 1].astype(np.int32), "nodes": nodes,
          "labels": labels[nodes]}
    return jb, {**jb, "draws": _reference_draws(key, len(nodes), _sage_fanouts())}


def _sage_fanouts():
    return configs.get_arch("graphsage-reddit").smoke_cfg.fanouts


def _reference_draws(key, size: int, fanouts) -> list:
    """The draws ``repro.models.gnn.forward_minibatch`` takes from ``key``."""
    draws = []
    for fan in fanouts:
        key, kk = jax.random.split(key)
        draws.append(np.asarray(jax.random.randint(kk, (size, fan), 0,
                                                   jnp.iinfo(jnp.int32).max)))
        size *= fan
    return draws


def _torch_batch(b: dict) -> dict:
    out = {}
    for k, v in b.items():
        if k == "key":
            continue
        out[k] = ([torch.from_numpy(np.array(x)) for x in v] if k == "draws"
                  else torch.from_numpy(np.array(v)))
    return out


def _reference_params(arch_id: str, ad_j, shape: str, seed: int):
    cfg = ad_j.model_cfg
    key = jax.random.PRNGKey(seed)
    if arch_id == "graphsage-reddit":
        return JG.init_params(key, dataclasses.replace(
            cfg, d_in=jcommon.GNN_SHAPES[shape]["d_feat"]))
    return JINIT[arch_id](key, cfg)


def _run_both(arch_id: str, shape: str, sparse: bool, seed: int = 3):
    """3 steps of the reference's jitted lowerable step and of the port's
    step from the same weights and batch -> (reference losses, port
    losses, reference params (flattened numpy), port model, initial
    weights (flattened numpy), port batch)."""
    ad_j = _smoke(j_get_arch(arch_id), sparse)
    ad = _smoke(configs.get_arch(arch_id), sparse)
    low = jcommon.build_lowerable(ad_j, shape, make_test_mesh((1, 1)))
    jp = _reference_params(arch_id, ad_j, shape, seed)
    init = convert._flatten(jax.tree.map(np.array, jp))
    cfg = configs.cell_config(ad, shape)
    to_port = (convert.sage_params_from_numpy if ad.family == "gnn"
               else convert.recsys_params_from_numpy)
    model = to_port(jax.tree.map(np.array, jp), cfg, "cpu")
    rng = np.random.default_rng(seed + 100)
    if ad.family == "gnn":
        jb, pb = _gnn_batch(rng, shape, cfg.n_classes)
    elif arch_id == "bert4rec":
        jb = pb = _bert4rec_batch(rng, cfg)
    else:
        jb = pb = _recsys_batch(rng, cfg)
    jstep = jax.jit(low.fn)
    jopt = jax.tree.map(lambda t: jnp.zeros(t.shape, t.dtype), low.args[1])
    jbatch = {k: jnp.asarray(v) for k, v in jb.items()}
    want = []
    for _ in range(STEPS):
        jp, jopt, loss = jstep(jp, jopt, jbatch)
        want.append(float(loss))
    model, state, step = configs.cell_train_step(ad, shape, "cpu", model=model)
    batch = _torch_batch(pb)
    got = []
    for _ in range(STEPS):
        state, loss = step(model, state, batch)
        got.append(float(loss))
    assert int(state["step"]) == STEPS
    return want, got, convert._flatten(jax.tree.map(np.array, jp)), model, init, batch


@pytest.mark.parametrize("arch_id,shape,sparse", CASES, ids=IDS)
def test_train_step_matches_the_reference_lowerable(arch_id, shape, sparse):
    want, got, jparams, model, init, batch = _run_both(arch_id, shape, sparse)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    assert all(np.isfinite(got))
    named = dict(model.named_parameters())
    assert set(named) == set(jparams)
    for name, p in named.items():
        w = jparams[name]
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=PARAM_TOL * scale,
                                   err_msg=name)
        assert not np.array_equal(p.detach().numpy(), init[name]) or name.startswith(
            ("tables.", "first.", "item_emb")), f"{name} did not move"
    if sparse:
        ids = batch["sparse"].long()
        for i, t in enumerate(model.tables):
            assert t.grad is None and not t.requires_grad
            untouched = np.ones(t.shape[0], bool)
            untouched[ids[:, i].numpy()] = False
            assert untouched.any() and not untouched.all()
            np.testing.assert_array_equal(t.detach().numpy()[untouched],
                                          init[f"tables.{i}"][untouched])
            # the reference's untouched rows are the same bits
            np.testing.assert_array_equal(jparams[f"tables.{i}"][untouched],
                                          init[f"tables.{i}"][untouched])


def test_sparse_step_optimizer_state_shadows_only_the_dense_parameters():
    ad = _smoke(configs.get_arch("dlrm-mlperf"), True)
    model, state, _ = configs.cell_train_step(ad, "train_batch", "cpu")
    names = {n for n, _ in model.named_parameters()}
    assert set(state["m"]) == {n for n in names if not n.startswith("tables.")}
    assert all(not t.requires_grad for t in model.tables)
    dense_ad = _smoke(configs.get_arch("dlrm-mlperf"), False)
    _, dense_state, _ = configs.cell_train_step(dense_ad, "train_batch", "cpu")
    assert set(dense_state["m"]) == names


def test_bert4rec_grad_accum_gives_the_batch_step():
    """Every row carries the same count of valid labels, so the mean of
    equal-sized microbatch means is the batch mean: 2 microbatches give the
    one-batch step's loss and parameters within fp32 rounding."""
    ad = _smoke(configs.get_arch("bert4rec"), False)
    cfg = ad.model_cfg
    batch = _torch_batch(_bert4rec_batch(np.random.default_rng(4), cfg, unused=False))
    assert bool((batch["labels"] >= 0).all())
    outs = []
    for accum in (1, 2):
        model, state, step = configs.cell_train_step(ad, "train_batch", "cpu", seed=2,
                                                     grad_accum=accum)
        losses = []
        for _ in range(2):
            state, loss = step(model, state, batch)
            losses.append(float(loss))
        outs.append((losses, {n: p.detach().clone() for n, p in model.named_parameters()}))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-6)
    for name, p in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][name], p, rtol=0,
                                   atol=PARAM_TOL * float(p.abs().max()))


def test_cell_train_step_refuses_what_it_does_not_train():
    with pytest.raises(ValueError, match="train cell"):
        configs.cell_train_step(configs.get_arch("deepfm"), "serve_p99", "cpu")
    with pytest.raises(ValueError, match="launch/train.py"):
        configs.cell_train_step(configs.get_arch("tinyllama-1.1b"), "train_4k", "cpu")
    with pytest.raises(ValueError, match="one microbatch"):
        configs.cell_train_step(_smoke(configs.get_arch("dlrm-mlperf"), True), "train_batch",
                                "cpu", grad_accum=2)


def test_archdef_extra_is_the_references_field():
    ad = configs.get_arch("dlrm-mlperf")
    assert ad.extra == {} and j_get_arch("dlrm-mlperf").extra == {}
    ad2 = dataclasses.replace(ad, extra={"sparse_emb_update": True, "tables_2d": True})
    assert ad2.extra["sparse_emb_update"] and configs.get_arch("dlrm-mlperf").extra == {}


@pytest.mark.parametrize("aggregator", ["sum", "mean"])
def test_edge_chunked_aggregate_is_the_one_pass_sum(monkeypatch, aggregator):
    """GraphSAGE's sum aggregate in chunks of edges (``gnn.EDGE_CHUNK``), and
    its gradient along the reversed edges, against one ``index_add_`` of
    the whole (E, d) messages under autograd: the forward bit for bit (the
    same additions in the same order on the CPU), the gradient within
    rtol 1e-6."""
    from repro_torch.models import gnn

    monkeypatch.setattr(gnn, "EDGE_CHUNK", 7)
    rng = np.random.default_rng(8)
    n, E = 40, 300
    edges = torch.from_numpy(rng.integers(0, n, (E, 2)).astype(np.int32))
    edges[:5, 1] = 3                                   # a destination with many sources
    h0 = torch.from_numpy(rng.standard_normal((n, 6), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((n, 6), dtype=np.float32))
    h = h0.clone().requires_grad_(True)
    got = gnn.aggregate(h, edges, n, aggregator)
    (gh,) = torch.autograd.grad(got, h, g)
    h = h0.clone().requires_grad_(True)
    src, dst = edges[:, 0].long(), edges[:, 1].long()
    want = torch.zeros(n, 6).index_add_(0, dst, h[src])
    if aggregator == "mean":
        want = want / torch.bincount(dst, minlength=n).float().clamp_min(1.0)[:, None]
    (wh,) = torch.autograd.grad(want, h, g)
    assert torch.equal(got, want)
    torch.testing.assert_close(gh, wh, rtol=1e-6, atol=1e-6)
