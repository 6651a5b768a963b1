"""The controls come out as not correct under the cells' own limits.

The precision control (the reference with TF32 products in the program's
place) needs the card: TF32 exists only there. It runs at a size a test run
can hold; ``control.py`` reads it at the cells' own size. It fails the
search answers' ``dist_err`` and the build's ``edge_dist_err``. The build
cell's guarantee control (the vertex left among its own nearest) runs
anywhere."""
import json
from pathlib import Path

import pytest

from annbench import conftest, harness

ROOT = Path(__file__).resolve().parent.parent


def _driver(cell, device, overrides):
    _, spec, config = harness.load_cell(ROOT, cell)
    config = harness.merge(config, overrides.get("config"))
    params = harness.merge(spec["params"], overrides.get("params"))
    drv = harness.load_driver(ROOT, spec["driver"])(config, params, 2**31 + 99, device)
    drv.make_data()
    return drv, spec["limits"]


def test_build_guarantee_control_is_not_correct():
    drv, limits = _driver("sift1m.build", "cpu", conftest.SMALL)
    readings = drv.control(1)
    correct, checks = harness.judge(readings["guarantee"], limits)
    assert not correct and checks["bad_entries"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sift1m.search", "gist1m.search"])
def test_search_precision_control_is_not_correct(cell, cuda_device):
    conf = json.loads((ROOT / f"annbench/configs/{cell.split('.')[0]}.json").read_text())
    small = {"config": {"data": {"n": 50_000}},
             "params": {"batch_rows": 2000,
                        "check": {"recall_sample": 500, "graph_sample": 64}}}
    drv, limits = _driver(cell, cuda_device, small)
    assert drv.world.base.shape == (50_000, conf["data"]["d"])
    correct, checks = harness.judge(drv.control(2)["precision"], limits)
    assert not correct and checks["dist_err"]["value"] > checks["dist_err"]["limit"]


@pytest.mark.cuda
def test_build_precision_control_is_not_correct(cuda_device):
    small = {"config": {"data": {"n": 50_000}}, "params": {"check": {"graph_sample": 256}}}
    drv, limits = _driver("sift1m.build", cuda_device, small)
    correct, checks = harness.judge(drv.control(1)["precision"], limits)
    assert not correct
    assert checks["edge_dist_err"]["value"] > checks["edge_dist_err"]["limit"]
