"""The result line's shape, the compared numbers printed last, and the
refusals: no card, or a checkout that holds only the benchmark."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from annbench import harness

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"] if w["name"] != "gist1m.search"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line(cell, trace, run_small):
    rc, r, err = run_small(cell, trace=trace)
    assert rc == 0
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks" and r["correct"] is True
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in harness.cell_metrics(BENCH, kind, cell)}
    assert set(r["metrics"]) <= set(units)
    assert all(m["unit"] == units[name] for name, m in r["metrics"].items())
    if trace:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(r["device"])
    else:
        assert set(r["metrics"]) == set(units)          # every end-to-end metric, never 0
        assert all(m["value"] > 0 for m in r["metrics"].values())
    checks = r["checks"]
    assert all(set(c) == {"value", "limit"} for c in checks.values())
    tail = err[-len(checks):]
    assert [line.split()[1] for line in tail] == list(checks)
    assert all(line.startswith("check ") and line.endswith(" ok") for line in tail)


def _run_py(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "annbench/run.py", "--workload", "sift1m.search",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result(cuda_absent):
    res = _run_py(ROOT)
    assert res.returncode != 0 and res.stdout == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(ROOT / "annbench", tmp_path / "annbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = _run_py(tmp_path)
    assert res.returncode != 0 and res.stdout == ""


@pytest.fixture
def cuda_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: this holds the refusal where there is none")
