"""The whole slice on the CPU: build (NN-Descent + GD, + PQ under
``--scorer pq``), batched beam search with random entries under the exact,
sq8 and pq scorers, ground truth, through ``repro_torch.launch.serve``,
against ``repro``'s ``Searcher.build`` + ``search`` on the same base and
queries (n=3000, d=16); and the device rule of the entry points.

recall@10 slack against the reference: 0.02 for exact and sq8, whose
tables are deterministic (only the random entries and NN-Descent's draws
differ); 0.03 for pq, whose codebooks also come from another generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bruteforce as jbrute
from repro.core.engine import Searcher as JSearcher
from repro.core.topk import recall_at_k as jrecall
from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.core import convert
from repro_torch.launch import serve
from repro_torch.models.transformer import init_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, D, BATCH, BATCHES = 3000, 16, 64, 2
SLACK = {"exact": 0.02, "sq8": 0.02, "pq": 0.03}


@pytest.fixture(scope="module")
def reference():
    """repro's index (with its build-time PQ table) and answers on the
    slice world (ef=64, k=10) under each scorer."""
    base = jnp.asarray(serve.numpy_world(N, D, 0))
    key = jax.random.PRNGKey(0)
    searcher = JSearcher.build(base, key=key, with_pq=True)
    spec = searcher.spec(ef=64, k=10)
    qs = serve.numpy_queries(D, BATCH, BATCHES, 0)
    entries = [np.asarray(searcher.seed(jnp.asarray(q), spec,
                                        jax.random.fold_in(key, b))[0])
               for b, q in enumerate(qs)]
    gt = jbrute.ground_truth(jnp.asarray(np.concatenate(qs)), base, 10)
    results, recall, nbytes = {}, {}, {}
    for scorer in ("exact", "sq8", "pq"):
        sp = spec._replace(scorer=scorer)
        results[scorer] = [searcher.search(jnp.asarray(q), sp, entries=jnp.asarray(e))
                           for q, e in zip(qs, entries)]
        found = jnp.concatenate([r.ids for r in results[scorer]])
        recall[scorer] = float(jrecall(found, gt))
        nbytes[scorer] = float(np.mean(np.concatenate(
            [np.asarray(r.bytes_touched) for r in results[scorer]])))
    return {
        "neighbors": np.asarray(searcher.neighbors),
        "entries": entries, "results": results["exact"], "queries": qs,
        "recall@10": recall["exact"], "recall": recall, "bytes": nbytes,
    }


def test_slice_recall_matches_reference(reference, monkeypatch, capsys):
    """The port's serve path at the slice world: recall@10 within 0.02 of
    the reference's, and the report lines the reference prints."""
    monkeypatch.setattr(serve, "SMOKE_WORLD", (N, D))
    out = serve.serve_ann(serve.parser().parse_args(
        ["--arch", "ann", "--smoke", "--device", "cpu", "--batch", str(BATCH),
         "--batches", str(BATCHES)])).summary
    assert abs(out["recall@10"] - reference["recall@10"]) <= 0.02, \
        (out["recall@10"], reference["recall@10"])
    assert out["queries"] == BATCH * BATCHES and out["qps"] > 0
    assert out["comps_per_query"] > 0 and out["device"] == "cpu"
    text = capsys.readouterr().out
    assert "[serve-ann] built nndescent·gd·none over n=3000 d=16" in text
    assert "recall@1=" in text and "comps/query=" in text


@pytest.mark.parametrize("scorer", ["sq8", "pq"])
def test_compressed_slice_recall_matches_reference(reference, scorer, monkeypatch,
                                                   capsys):
    """The serve path under --scorer sq8 / pq: recall@10 within SLACK of
    the reference's under the same scorer, bytes/query within 5% of its
    (the same billing over walks of the same length), and the reference's
    report lines."""
    monkeypatch.setattr(serve, "SMOKE_WORLD", (N, D))
    out = serve.serve_ann(serve.parser().parse_args(
        ["--arch", "ann", "--smoke", "--device", "cpu", "--batch", str(BATCH),
         "--batches", str(BATCHES), "--scorer", scorer])).summary
    want = reference["recall"][scorer]
    assert abs(out["recall@10"] - want) <= SLACK[scorer], (out["recall@10"], want)
    assert out["scorer"] == scorer and out["queries"] == BATCH * BATCHES
    want_bytes = reference["bytes"][scorer]
    assert abs(out["bytes_per_query"] - want_bytes) <= 0.05 * want_bytes, \
        (out["bytes_per_query"], want_bytes)
    assert want_bytes < reference["bytes"]["exact"]
    text = capsys.readouterr().out
    if scorer == "pq":
        assert "[serve-ann] built nndescent·gd·pq over n=3000 d=16" in text
        assert "[serve-ann] pq scorer ready in" in text and "(attached): M=8 K=256" in text
    assert f"scorer={scorer}" in text and "bytes/query=" in text


def test_reference_graph_and_entries_give_identical_answers(reference):
    """With repro's graph and entries carried across by core/convert.py,
    the port returns identical ids, comps and steps."""
    base = serve.numpy_world(N, D, 0)
    s = convert.searcher_from_numpy(base, reference["neighbors"], device="cpu")
    spec = s.spec(ef=64, k=10)
    for q, e, want in zip(reference["queries"], reference["entries"],
                          reference["results"]):
        got = s.search(convert.tensor(q, torch.float32, "cpu"), spec,
                       entries=convert.tensor(e, torch.int32, "cpu"))
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_array_equal(got.n_comps.numpy(), np.asarray(want.n_comps))
        assert int(got.n_steps) == int(want.n_steps)
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                                   rtol=1e-5, atol=1e-6)


def test_streamed_serving_answers_every_query(monkeypatch):
    monkeypatch.setattr(serve, "SMOKE_WORLD", (600, 8))
    out = serve.serve_ann(serve.parser().parse_args(
        ["--arch", "ann", "--smoke", "--device", "cpu", "--batch", "40",
         "--batches", "2", "--stream-tile", "16", "--build-rounds", "4",
         "--diversify", "none"])).summary
    assert out["queries"] == 80 and out["recall@10"] > 0.5


def test_entry_points_raise_without_a_gpu(monkeypatch):
    """Asking for cuda where none exists raises; nothing carries on quietly
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device(dev)
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--arch", "ann", "--smoke"])
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--arch", "tinyllama-1.1b", "--smoke"])
    with pytest.raises(RuntimeError, match="is_available"):
        init_params(get_arch("h2o-danube-1.8b").smoke_cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        convert.tensor(np.zeros(3), torch.float32)
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_cli_rejects_other_archs(capsys):
    # a recsys arch is served now (item retrieval under ip); an unknown one is refused
    assert serve.parser().parse_args(["--arch", "dlrm-mlperf"]).arch == "dlrm-mlperf"
    with pytest.raises(SystemExit):
        serve.parser().parse_args(["--arch", "dlrm-v2"])
    err = capsys.readouterr().err
    assert "'dlrm-v2' is not an arch of the port" in err and "dlrm-mlperf" in err
