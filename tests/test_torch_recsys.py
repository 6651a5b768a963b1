"""The port's recsys family on the CPU against live calls into repro: the
configs, ``embedding_bag``, the four models at their smoke configs on the
reference's own weights (carried across by ``models/convert.py``), the
BERT4Rec loss and its gradients, the synthetic batches built from the
reference's draws, retrieval under the inner product, and the serve CLI's
retrieval branch.

Tolerances: model outputs, scores and losses within rtol 1e-5, atol 1e-5
(fp32 sums in another order); gradients within 1e-5 of each leaf's max-abs;
``embedding_bag`` within rtol 1e-6, atol 1e-6 (one fp32 sum per bag).
Batches built from the reference's draws are bit-identical. Retrieval given
the same items, graph and entries: ids, ``n_comps`` and ``n_steps``
identical, dists within rtol 1e-5; GD given a ``KnnGraph`` identical except
rows whose keep decision sits on a float32 near-tie. The retrieval example
(``examples/recsys_retrieval_torch.py --device cpu --n 4000``) reaches the
reference example's filtered recall@10 on the same arguments less
EXAMPLE_RECALL_SLACK: both gave 1.000 (the port at seeds 0-2); one missed
item of the 140 answers costs 0.0071.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import autoint as j_autoint
from repro.configs import bert4rec as j_bert4rec
from repro.configs import deepfm as j_deepfm
from repro.configs import dlrm_mlperf as j_dlrm
from repro.configs import get_arch as j_get_arch
from repro.core import beam_search as jbeam
from repro.core import bruteforce as jbrute
from repro.core import diversify as jdiv
from repro.core import nndescent as jnd
from repro.data import synthetic as jsyn
from repro.models import recsys as JR
from repro_torch import configs
from repro_torch.core import convert as core_convert
from repro_torch.core import diversify
from repro_torch.data import synthetic
from repro_torch.launch import serve
from repro_torch.models import convert, recsys
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
BAG_TOL = dict(rtol=1e-6, atol=1e-6)
JMODS = {"dlrm-mlperf": j_dlrm, "deepfm": j_deepfm, "autoint": j_autoint,
         "bert4rec": j_bert4rec}
JINIT = {"dlrm-mlperf": JR.dlrm_init, "deepfm": JR.deepfm_init, "autoint": JR.autoint_init,
         "bert4rec": JR.bert4rec_init}


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out.pop("dtype")
    return out


def _models(arch_id, seed=0):
    """The reference's smoke params and the port's model on the same weights."""
    jcfg = JMODS[arch_id].SMOKE
    jp = JINIT[arch_id](jax.random.PRNGKey(seed), jcfg)
    cfg = configs.get_arch(arch_id).smoke_cfg
    return jp, jcfg, convert.recsys_params_from_numpy(_np_tree(jp), cfg, "cpu")


def _ids(vocab_sizes, B, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, v, B) for v in vocab_sizes], axis=1).astype(np.int32)


# -- configs ---------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", list(JMODS))
def test_port_configs_copy_the_reference(arch_id):
    ad, jad = configs.get_arch(arch_id), j_get_arch(arch_id)
    assert (ad.family, ad.optimizer) == (jad.family, jad.optimizer) == ("recsys", "adamw")
    for mine, theirs in ((ad.model_cfg, jad.model_cfg), (ad.smoke_cfg, jad.smoke_cfg)):
        assert type(mine).__name__ == type(theirs).__name__
        assert _fields(mine) == _fields(theirs)
        assert mine.dtype == torch.float32 and theirs.dtype == jnp.float32
    assert [dataclasses.astuple(c) for c in ad.cells()] == \
        [dataclasses.astuple(c) for c in jad.cells()]
    assert configs.cell_config(ad, "serve_p99") is ad.model_cfg


def test_registry_families_and_shapes_are_the_reference():
    from repro.configs import common as jcommon
    from repro.configs import list_archs as j_list

    assert sorted(configs.list_archs()) == sorted(j_list())
    for fam in ("lm", "recsys", "gnn"):
        assert sorted(configs.list_archs(fam)) == sorted(
            a for a in j_list() if j_get_arch(a).family == fam)
    assert configs.RECSYS_SHAPES == jcommon.RECSYS_SHAPES
    assert configs.GNN_SHAPES == jcommon.GNN_SHAPES
    # the same cells, arch by arch
    for a in configs.list_archs():
        assert [dataclasses.astuple(c) for c in configs.get_arch(a).cells()] == \
            [dataclasses.astuple(c) for c in j_get_arch(a).cells()]


# -- embedding_bag ----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(mode):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((50, 6), dtype=np.float32)
    seg = np.sort(rng.choice([0, 1, 2, 4, 5, 7], 40)).astype(np.int32)   # bags 3, 6 empty
    ids = rng.integers(0, 50, 40).astype(np.int32)
    want = np.asarray(JR.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg),
                                       8, mode))
    got = recsys.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                               torch.from_numpy(seg), 8, mode).numpy()
    np.testing.assert_allclose(got, want, **BAG_TOL)
    assert (got[[3, 6]] == 0).all()
    with pytest.raises(ValueError, match="mode"):
        recsys.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                             torch.from_numpy(seg), 8, "min")


# -- the models -------------------------------------------------------------------


@pytest.mark.parametrize("case", ["dlrm", "dlrm-rows", "deepfm", "autoint"])
def test_forward_matches_reference(case):
    arch_id = {"dlrm": "dlrm-mlperf", "dlrm-rows": "dlrm-mlperf"}.get(case, case)
    jp, jcfg, model = _models(arch_id, seed=3)
    B = 24
    sparse = _ids(jcfg.vocab_sizes, B, seed=4)
    if arch_id == "dlrm-mlperf":
        dense = np.random.default_rng(5).standard_normal((B, jcfg.n_dense), dtype=np.float32)
        rows = None
        if case == "dlrm-rows":
            rows = [np.asarray(t)[sparse[:, i]] for i, t in enumerate(jp["tables"])]
        want = JR.dlrm_forward(jp, jnp.asarray(dense), jnp.asarray(sparse), jcfg,
                               rows=None if rows is None else [jnp.asarray(r) for r in rows])
        got = model(torch.from_numpy(dense), torch.from_numpy(sparse),
                    rows=None if rows is None else [torch.from_numpy(r) for r in rows])
    elif arch_id == "deepfm":
        want = JR.deepfm_forward(jp, jnp.asarray(sparse), jcfg)
        got = model(torch.from_numpy(sparse))
    else:
        want = JR.autoint_forward(jp, jnp.asarray(sparse), jcfg)
        got = model(torch.from_numpy(sparse))
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _b4r_items(jcfg, B, seed=6):
    """Item sequences with mask tokens and pad tokens (two rows end in pads)."""
    rng = np.random.default_rng(seed)
    items = rng.integers(0, jcfg.n_items, (B, jcfg.seq_len)).astype(np.int32)
    items[rng.random(items.shape) < 0.15] = jcfg.mask_token
    items[0, -3:] = jcfg.pad_token
    items[1, :5] = jcfg.pad_token
    return items


def test_bert4rec_hidden_and_next_item_scores_match_reference():
    jp, jcfg, model = _models("bert4rec", seed=7)
    items = _b4r_items(jcfg, 6)
    want = JR.bert4rec_forward(jp, jnp.asarray(items), jcfg)
    got = model(torch.from_numpy(items))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_s = (want[:, -1] @ jp["item_emb"].T).astype(jnp.float32)      # common.py's serve step
    got_s = recsys.next_item_scores(model, torch.from_numpy(items))
    assert got_s.shape == (6, jcfg.vocab) and got_s.dtype == torch.float32
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


def test_bert4rec_gelu_is_the_tanh_form():
    """A hidden state that reads jax.nn.gelu's default (tanh) and not
    torch's default (erf): the port's block must match the tanh form."""
    x = torch.linspace(-4, 4, 101)
    tanh_form = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(torch.nn.functional.gelu(x, approximate="tanh").numpy(),
                               tanh_form, rtol=1e-5, atol=1e-6)
    assert not np.allclose(torch.nn.functional.gelu(x).numpy(), tanh_form, rtol=1e-5,
                           atol=1e-6)


def test_bert4rec_loss_and_gradients_match_reference():
    jp, jcfg, model = _models("bert4rec", seed=8)
    B, M = 4, 5
    items = _b4r_items(jcfg, B, seed=9)
    rng = np.random.default_rng(10)
    pos = np.stack([rng.choice(jcfg.seq_len, M, replace=False) for _ in range(B)]).astype(
        np.int32)
    labels = rng.integers(0, jcfg.n_items, (B, M)).astype(np.int32)
    labels[0, :2] = -100                                    # unused slots
    loss_w, grads_w = jax.value_and_grad(JR.bert4rec_loss)(
        jp, jnp.asarray(items), jnp.asarray(pos), jnp.asarray(labels), jcfg)
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss = recsys.bert4rec_loss(model, torch.from_numpy(items), torch.from_numpy(pos),
                                torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss.detach()), float(loss_w), **TOL)
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    want = convert._flatten(_np_tree(grads_w))
    assert set(want) == set(grads)
    for name, g in grads.items():
        scale = max(float(np.abs(want[name]).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def test_init_params_draw_the_reference_law():
    """The port's own draws: the reference's scales (tables v**-0.25, MLP
    fan_in**-0.5, BERT4Rec embeddings D**-0.5, biases 0, norms 1), the same
    tree, reproducible from the seed."""
    for arch_id in JMODS:
        cfg = configs.get_arch(arch_id).smoke_cfg
        a = recsys.init_params(cfg, 0, "cpu")
        b = recsys.init_params(cfg, 0, "cpu")
        jp = _np_tree(JINIT[arch_id](jax.random.PRNGKey(0), JMODS[arch_id].SMOKE))
        want = convert._flatten(jp)
        pa = dict(a.named_parameters())
        assert set(pa) == set(want)
        for name, p in pa.items():
            assert tuple(p.shape) == want[name].shape and not p.requires_grad
            assert torch.equal(p, dict(b.named_parameters())[name])
            w = want[name]
            if np.all(w == w.flat[0]):
                assert torch.all(p == float(w.flat[0])), name
            elif p.numel() >= 512:
                assert abs(float(p.std()) / float(w.std()) - 1) < 0.15, name


def test_converter_names_mismatched_leaves():
    jp, _, _ = _models("deepfm")
    tree = _np_tree(jp)
    cfg = configs.get_arch("deepfm").smoke_cfg
    del tree["bias"]
    tree["extra"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match=r"missing \['bias'\], extra \['extra'\]"):
        convert.recsys_params_from_numpy(tree, cfg, "cpu")
    tree = _np_tree(jp)
    tree["mlp"][0]["w"] = tree["mlp"][0]["w"][:-1]
    with pytest.raises(ValueError, match="mlp.0.w"):
        convert.recsys_params_from_numpy(tree, cfg, "cpu")


# -- synthetic batches from the reference's draws ------------------------------------


@pytest.mark.parametrize("n_dense", [0, 13])
def test_recsys_batch_on_the_reference_draws_is_the_reference_batch(n_dense):
    vocab = j_dlrm.SMOKE.vocab_sizes[:20] + (7, 100_003, 3, 1 << 20, 11, 2)
    key = jax.random.PRNGKey(5)
    B = 256
    ks, kd, kl = jax.random.split(key, 3)
    raw = jax.random.randint(ks, (B, len(vocab)), 0, 1 << 30)
    dense = jax.random.normal(kd, (B, n_dense)) if n_dense else None
    u = jax.random.uniform(kl, (B,))
    got = synthetic.recsys_from_draws(_t(raw), None if dense is None else _t(dense), _t(u),
                                      vocab)
    want = jsyn.recsys_batch(key, B, vocab, n_dense)
    assert list(got) == list(want)
    for name in want:
        assert got[name].numpy().dtype == np.asarray(want[name]).dtype, name
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    own = synthetic.recsys_batch(torch.Generator().manual_seed(1), B, vocab, n_dense)
    assert list(own) == list(want) and own["sparse"].shape == (B, len(vocab))
    assert bool((own["sparse"] < torch.tensor(vocab)).all())


def test_bert4rec_batch_on_the_reference_draws_is_the_reference_batch():
    key = jax.random.PRNGKey(2)
    B, S, n_items = 8, 30, 97
    k1, k2, k3 = jax.random.split(key, 3)
    step_sz = jax.random.randint(k1, (B, 1), 1, 7)
    start = jax.random.randint(k2, (B, 1), 0, n_items)
    masked = jax.random.uniform(k3, (B, S)) < 0.15
    got = synthetic.bert4rec_from_draws(
        *(_t(x) for x in (step_sz, start, masked)), n_items, n_items)
    want = jsyn.bert4rec_batch(key, B, S, n_items, n_items)
    for name in ("items", "labels"):
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    own = synthetic.bert4rec_batch(torch.Generator().manual_seed(0), 64, 200, n_items, n_items)
    share = float((own["labels"] >= 0).float().mean())
    assert 0.12 < share < 0.18                    # Bernoulli(0.15), not a fixed count


# -- retrieval under the inner product -----------------------------------------------


@pytest.fixture(scope="module")
def ip_world():
    """n=2000, d=16 items, 40 queries, the reference's NN-Descent graph under
    ip (k=16, 8 rounds) and its GD graph, and its 16 random entries a query."""
    rng = np.random.default_rng(11)
    items = rng.standard_normal((2000, 16), dtype=np.float32)
    queries = rng.standard_normal((40, 16), dtype=np.float32)
    knn = jnd.build_knn_graph(jnp.asarray(items), jnd.NNDescentConfig(k=16, rounds=8),
                              metric="ip", key=jax.random.PRNGKey(1))
    gd = jdiv.build_gd_graph(jnp.asarray(items), knn, metric="ip")
    entries = np.array(jbeam.random_entries(jax.random.PRNGKey(0), 2000, 40, 16))
    return items, queries, knn, np.array(gd.neighbors), entries


def test_gd_under_ip_given_a_knn_graph_matches_reference(ip_world):
    items, _, knn, want, _ = ip_world
    got = diversify.build_gd_graph(torch.from_numpy(items), core_convert.graph_from_numpy(
        knn.neighbors, knn.dists, "cpu"), metric="ip").neighbors.numpy()
    diff = np.nonzero((got != want).any(axis=1))[0]
    # rows that differ must hold a float32 near-tie of the occlusion test
    # (-<s, c> against -<v, c>, within 1e-5 of the candidate's score)
    for r in diff:
        c = np.asarray(knn.neighbors)[r]
        c = c[c >= 0]
        x = items[c].astype(np.float64)
        pair, cand = -(x @ x.T), -(x @ items[r].astype(np.float64))
        close = np.abs(pair - cand[None, :]) < 1e-5 * np.abs(cand[None, :])
        np.fill_diagonal(close, False)
        assert close.any(), r
    assert len(diff) <= 0.01 * len(got)


def test_exact_retrieval_matches_reference(ip_world):
    items, queries, *_ = ip_world
    wd, wi = JR.retrieval_score_exact(jnp.asarray(queries), jnp.asarray(items), k=100)
    gd, gi = recsys.retrieval_score_exact(torch.from_numpy(queries), torch.from_numpy(items),
                                          k=100)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **TOL)


def test_ann_retrieval_given_graph_and_entries_matches_reference(ip_world):
    items, queries, _, nbrs, entries = ip_world
    wd, wi = JR.retrieval_score_ann(jnp.asarray(queries), jnp.asarray(items),
                                    jnp.asarray(nbrs), k=10, ef=96)   # key PRNGKey(0)
    want = jbeam.beam_search(jnp.asarray(queries), jnp.asarray(items), jnp.asarray(nbrs),
                             jnp.asarray(entries), ef=96, k=10, metric="ip")
    np.testing.assert_array_equal(np.asarray(wi), np.asarray(want.ids))
    got = recsys.retrieval_score_ann(torch.from_numpy(queries), torch.from_numpy(items),
                                     torch.from_numpy(nbrs), k=10, ef=96,
                                     entries=torch.from_numpy(entries))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.n_comps.numpy(), np.asarray(want.n_comps))
    assert int(got.n_steps) == int(want.n_steps)
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(wd), **TOL)
    # the port's own entries: min(16, ef) a query from the generator
    own = recsys.retrieval_score_ann(torch.from_numpy(queries), torch.from_numpy(items),
                                     torch.from_numpy(nbrs), k=10, ef=32)
    assert own.ids.shape == (40, 10) and int(own.n_comps.min()) > 0


# -- the serve CLI -------------------------------------------------------------------


# the reference's recall@1 / @10 on the smoke world, 512 queries, seed 0
# (scripts/reference_smoke_recall.py --retrieval); over seeds 0-2 the port's
# CPU runs sat within 0.0098 of them (other generators draw NN-Descent and
# the entries), so the slack is twice that
REF_SMOKE_RETRIEVAL = (0.88671875, 0.784960925579071)
RETRIEVAL_SLACK = 0.02


@pytest.mark.parametrize("arch_id", ["dlrm-mlperf", "deepfm", "autoint", "bert4rec",
                                     "graphsage-reddit"])
def test_serve_cli_serves_retrieval(arch_id, monkeypatch, capsys):
    """The reference's non-LM branch: exact ms, ANN ms and recall@1 printed.
    dlrm-mlperf on the smoke world with 512 queries, held to the reference's
    recall less RETRIEVAL_SLACK; the other ids on a (3000, 16) world (cut
    for test time), recall against the exact top 10 of that world."""
    world, batch = (serve.SMOKE_WORLD, 512) if arch_id == "dlrm-mlperf" else ((3000, 16), 32)
    monkeypatch.setattr(serve, "SMOKE_WORLD", world)
    run = serve.main(["--arch", arch_id, "--smoke", "--device", "cpu", "--batch", str(batch)])
    out = capsys.readouterr().out
    assert f"[serve] exact retrieval over {world[0]}:" in out and "recall@1=" in out
    sm = run.summary
    assert (sm["n"], sm["d"], sm["queries"], sm["arch"]) == (*world, batch, arch_id)
    assert run.ann.ids.shape == run.exact[1].shape == (batch, 10)
    if arch_id == "dlrm-mlperf":
        assert sm["recall@1"] >= REF_SMOKE_RETRIEVAL[0] - RETRIEVAL_SLACK
        assert sm["recall@10"] >= REF_SMOKE_RETRIEVAL[1] - RETRIEVAL_SLACK
    assert sm["recall@1"] >= 0.8 and sm["recall@10"] >= 0.6
    assert sm["comps_per_query"] > 0 and run.graph.neighbors.shape[0] == world[0]
    ids = run.exact[1].numpy()
    brute = np.argsort(-(run.queries.numpy() @ run.items.numpy().T), axis=1,
                       kind="stable")[:, :10]
    np.testing.assert_array_equal(ids, brute)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--arch", arch_id, "--smoke"])


# -- the retrieval example and the train CLI ------------------------------------------


ROOT = Path(__file__).resolve().parent.parent
EXAMPLE_RECALL_SLACK = 0.01


def _run(args: list, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env={**os.environ, "PYTHONPATH": "src", **env})


def _recall_line(out: str) -> float:
    return float(re.search(r"filtered recall@10 after rerank: ([0-9.]+)", out).group(1))


def test_retrieval_example_runs_on_the_cpu_at_the_references_recall():
    """The port's example exits 0 (served == direct, no filter leak, the
    cold-start tenant empty: its assertions), prints the reference
    example's lines on the same catalog, and reaches its recall less the
    slack; the reference example runs unedited in a child."""
    port = _run(["examples/recsys_retrieval_torch.py", "--device", "cpu", "--n", "4000"])
    assert port.returncode == 0, port.stderr[-2000:]
    ref = _run(["examples/recsys_retrieval.py", "--n", "4000"], JAX_PLATFORMS="cpu")
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert "cold-start tenant: empty result set, 0 comparisons" in port.stdout
    # the same catalog: each request's servable count and path are the reference's
    pick = re.compile(r"^(.*): (\d+) queries, (\d+) servable items \[(\S+)\]", re.M)
    assert pick.findall(port.stdout) == pick.findall(ref.stdout) != []
    assert "[exact-scan]" in port.stdout and "[graph]" in port.stdout
    assert _recall_line(port.stdout) >= _recall_line(ref.stdout) - EXAMPLE_RECALL_SLACK


def test_train_cli_refuses_the_recsys_archs_naming_their_train_steps():
    res = _run(["-m", "repro_torch.launch.train", "--arch", "dlrm-mlperf"])
    assert res.returncode == 2 and "configs.common" in res.stderr, res.stderr
    assert "not ported" not in res.stderr
