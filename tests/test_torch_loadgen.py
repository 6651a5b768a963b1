"""The port's load generator (``repro_torch.launch.loadgen``) on the CPU.

Arrivals, request sizes and pool offsets come from the reference's numpy
draws, so they equal ``benchmarks/loadgen.py``'s bit for bit; request i's
seed is ``_fold(base_seed, i)``. The CLI's closed and mutation modes exit 0
at the reference's defaults (n=3,000, d=16), which gates every served
request bit-identical to its direct search, nothing shed or built after
the hot swap, no tombstoned answer and compaction equal to a fresh build.
A short sweep runs the open loop at two load factors.
"""
import numpy as np
import pytest
import torch

from benchmarks import loadgen as jloadgen
from repro_torch.core.engine import _fold
from repro_torch.launch import loadgen
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("qps,n,seed", [(500.0, 200, 0), (3.7, 17, 1001), (1e4, 1, 5)])
def test_poisson_arrivals_match_reference(qps, n, seed):
    np.testing.assert_array_equal(loadgen.poisson_arrivals(qps, n, seed),
                                  jloadgen.poisson_arrivals(qps, n, seed))


@pytest.mark.parametrize("sizes", [loadgen.REQUEST_SIZES, (1, 8), (3,)])
def test_make_requests_match_reference_draws(sizes):
    import jax

    pool = np.random.default_rng(0).standard_normal((256, 16), dtype=np.float32)
    got = loadgen.make_requests(pool, 120, sizes, seed=4, base_seed=77)
    want = jloadgen.make_requests(pool, 120, sizes, 4, jax.random.PRNGKey(77))
    assert [r.start for r in got] == [r.start for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.rows, w.rows)
    assert [r.seed for r in got] == [_fold(77, i) for i in range(120)]
    assert loadgen.LOAD_FACTORS == jloadgen.LOAD_FACTORS
    assert loadgen.REQUEST_SIZES == jloadgen.REQUEST_SIZES
    assert tuple(loadgen.SWEEP_CONFIG) == tuple(jloadgen.SWEEP_CONFIG)


@pytest.mark.parametrize("mode", ["closed", "mutation"])
def test_cli_modes_exit_zero(mode, capsys):
    loadgen.main(["--mode", mode, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "OK" in out and "FAIL" not in out
    if mode == "closed":
        assert "completed=200 shed=0" in out and "parity=200/200" in out
    else:
        assert "parity A=100/100 B=100/100, dead-id answers=0" in out
        assert "compact==fresh-build: True" in out


def test_serving_sweep_small_world():
    """Two load points over a small world: every completed request equals
    its direct search, completed + shed = requests, timestamps in order,
    and the batch twins' recall is the served recall at full completion."""
    searcher, pool, gt = loadgen._build_world(800, 8, 64, 3, torch.device("cpu"))
    spec = searcher.spec(ef=16, k=1)
    lines = []
    sweep = loadgen.serving_sweep(searcher, spec, pool, gt, load_factors=(0.5, 3.0),
                                  n_requests=16, seed=2, out=lines.append)
    assert lines[0].startswith("loadgen/baseline: capacity=") and len(lines) == 3
    assert sweep["serving_capacity_qps"] > 0 and sweep["serving_ref_wall_ms"] > 0
    for row in sweep["serving_sweep"]:
        assert row["parity"] == 1.0
        assert row["completed"] + row["shed"] == 16
        assert row["timestamps_ordered"]
        assert row["max_live"] >= 1
        if row["shed"] == 0:
            assert row["recall_at_1"] == sweep["serving_batch_recall_at_1"]
            assert row["comps_per_query"] == sweep["serving_batch_comps_per_query"]
