"""BENCHMARK.json against the files the harness finds by name, and a cell, a
configuration and a per-layer metric added by adding files alone."""
import json
import re
import shutil
from pathlib import Path

import pytest

from annbench import harness

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_names_units_and_sources():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + metrics]
    assert all(NAME.fullmatch(n) for n in names) and len(set(names)) == len(names)
    assert all(UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert all(m["source"] in ("host_clock", "device_trace") for m in BENCH["end_to_end"])
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_are_found_by_name(cell):
    entry, spec, config = harness.load_cell(ROOT, cell)
    assert entry["chips"] == 1 and config["name"] == entry["config"]
    assert harness.load_driver(ROOT, spec["driver"]).kind in ("search", "build")
    assert set(spec["limits"]) and all(v >= 0 for v in spec["limits"].values())
    reported = harness.cell_metrics(BENCH, "end_to_end", cell)
    assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    assert harness.cell_metrics(BENCH, "per_layer", cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metric_has_its_reader(metric):
    assert callable(harness.load_reader(ROOT, metric))


def test_configs_are_files_of_their_own_at_published_scale():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"] == []
        assert conf["data"]["n"] == 1_000_000 and conf["assumed"]


def test_a_cell_a_config_and_a_metric_added_as_files(tmp_path, run_small):
    """A copy of the checkout's benchmark gains a configuration, a cell and
    a per-layer metric by new files and new entries only, and runs them."""
    shutil.copytree(ROOT / "annbench", tmp_path / "annbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    conf = json.loads((ROOT / "annbench/configs/sift1m.json").read_text())
    conf.update(name="tiny", reduced=["n"])
    conf["data"].update(n=1000, d=8, latent=3)
    (tmp_path / "annbench/configs/tiny.json").write_text(json.dumps(conf))
    cell = json.loads((ROOT / "annbench/workloads/sift1m.search.json").read_text())
    cell["config"] = "tiny"
    (tmp_path / "annbench/workloads/tiny.search.json").write_text(json.dumps(cell))
    (tmp_path / "annbench/metrics/answered_rows.py").write_text(
        "def read(obs):\n    return obs.get('search', {}).get('rows')\n")
    bench["configs"].append({"name": "tiny", "source": "a test", "reduced": ["n"],
                             "file": "annbench/configs/tiny.json", "why": "a test"})
    bench["workloads"].append({"name": "tiny.search", "config": "tiny", "traffic": "search",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sift1m.search" in m.get("workloads", []):
            m["workloads"].append("tiny.search")
    bench["per_layer"].append({"name": "answered_rows", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "test", "moves": "qps",
                               "workloads": ["tiny.search"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    small = {"params": {"batch_rows": 64, "trace_batches": 1,
                        "check": {"recall_sample": 64, "graph_sample": 32}}}
    rc, result, _ = run_small("tiny.search", trace=True, root=tmp_path, overrides=small)
    assert rc == 0 and result["correct"]
    assert result["metrics"]["answered_rows"]["value"] == result["attempted"]
    assert {"beam_steps", "step_ms", "comps_per_query"} <= set(result["metrics"])
