"""The plain reference against float64 NumPy: brute force, GD's rule, the
adjacency's invariants, the answer readings and the seeded data."""
import numpy as np
import pytest
import torch

from annbench.reference import check, data, graph, knn


def _points(n=1500, d=12, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, d))).float()


def _np_knn(q, x, k, exclude=None):
    d = ((q.double().numpy()[:, None, :] - x.double().numpy()[None, :, :]) ** 2).sum(-1)
    if exclude is not None:
        d[np.arange(len(q)), exclude.numpy()] = np.inf
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, ids, 1), ids


def test_exact_knn_matches_float64_numpy():
    x, q = _points(), _points(40, seed=1)
    d, ids = knn.exact_knn(q, x, 10)
    want_d, want_ids = _np_knn(q, x, 10)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(d.numpy(), want_d, rtol=1e-12)


def test_exact_knn_leaves_out_each_vertex_itself():
    x = _points()
    v = torch.tensor([0, 7, 1499])
    d, ids = knn.exact_knn(x[v], x, 5, exclude=v)
    want_d, want_ids = _np_knn(x[v], x, 5, exclude=v)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    assert not (ids == v[:, None]).any()


def _np_gd(u, cand, x, max_keep):
    kept = []
    for c in cand:
        duc = ((x[c] - u) ** 2).sum()
        if len(kept) < max_keep and all(((x[s] - x[c]) ** 2).sum() > duc for s in kept):
            kept.append(c)
    return kept


def test_gd_keep_is_the_occlusion_rule_in_float64():
    x = _points(600, 6)
    v = torch.arange(30)
    _, cand = knn.exact_knn(x[v], x, 12, exclude=v)
    keep = graph.gd_keep(x[v], cand, x, max_keep=6)
    xn = x.double().numpy()
    for r in range(30):
        want = _np_gd(xn[r], cand[r].numpy(), xn, 6)
        assert cand[r][keep[r]].tolist() == want


def test_bad_entries_counts_each_broken_invariant():
    nbrs = torch.tensor([[1, 2, -1], [0, 1, 2], [5, 0, 0], [-2, 1, -1]])
    # row 1: a self loop; row 2: id 5 out of range and 0 twice; row 3: -2 out of range
    assert graph.bad_entries(nbrs, n=4) == 4
    assert graph.bad_entries(nbrs[:1], n=4) == 0


def test_answer_judge_readings():
    x, q = _points(), _points(50, seed=2)
    d64, ids = knn.exact_knn(q, x, 10)
    judge = check.AnswerJudge(x, 10)
    judge.add(q, ids, d64.float())
    r = judge.readings()
    assert (r["bad_answers"], r["recall_at_10"], r["answered"]) == (0, 1.0, 50)
    assert r["dist_err"] < 1e-6
    wrong = ids.clone()
    wrong[:, 0] = ids[:, 9]                       # an id twice, its distance now wrong
    judge = check.AnswerJudge(x, 10)
    judge.add(q, wrong, d64.float(), recall_rows=torch.arange(10))
    r = judge.readings()
    assert r["bad_answers"] == 50 and r["dist_err"] > 1e-2
    assert r["recall_rows"] == 10 and r["recall_at_10"] == pytest.approx(0.9)


def test_judge_rows_on_exact_gd_rows():
    x = _points(800, 6)
    v = torch.arange(0, 800, 20)
    _, cand = knn.exact_knn(x[v], x, 10, exclude=v)
    rows = torch.where(graph.gd_keep(x[v], cand, x, 5), cand, -1)
    r = check.judge_rows(x, v, rows, L=10, max_keep=5)
    assert r == {"nn1_miss": 0.0, "gd_keep_miss": 0.0}
    r = check.judge_rows(x, v, torch.full_like(rows, -1), L=10, max_keep=5)
    assert (r["nn1_miss"], r["gd_keep_miss"]) == (1.0, 1.0)


def test_world_is_one_point_set_in_each_seed_order():
    a = data.make_world(1, 500, 8, 3, data_seed=9, device="cpu")
    b = data.make_world(2**31 + 7, 500, 8, 3, data_seed=9, device="cpu")
    again = data.make_world(1, 500, 8, 3, data_seed=9, device="cpu")
    assert torch.equal(a.base, again.base)
    assert not torch.equal(a.base, b.base)
    by_first = [t[torch.argsort(t[:, 0])] for t in (a.base, b.base)]
    assert torch.equal(*by_first)
    q = data.query_batch(a, 3, 20)
    assert torch.equal(q, data.query_batch(again, 3, 20))
    assert not torch.equal(q, data.query_batch(a, 4, 20))
    assert data.substream(1, "x") != data.substream(1, "x", 1)
