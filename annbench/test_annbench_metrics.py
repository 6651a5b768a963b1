"""The benchmark's metric arithmetic and each per-layer reader on hand-made
inputs."""
import json
from pathlib import Path

import pytest
import torch

from annbench import harness
from annbench.metrics import _lib

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_hop_bytes_counts_each_byte_once():
    # 3 scored ids at d=4: (16 + 4) each; 10 slots: 12 each; at R=2 the 3 ids
    # need 2 launches at least, each reading a 16-byte query row
    assert _lib.hop_bytes(n_comps=3, slots=10, R=2, d=4) == 60 + 120 + 32
    assert _lib.hop_bytes(n_comps=4, slots=10, R=2, d=4) == 80 + 120 + 32


def test_roofline_pct():
    assert _lib.roofline_pct(3.35e9, 2e-3) == pytest.approx(50.0)
    assert _lib.roofline_pct(1.0, 0.0) is None


def test_merge_and_busy_within():
    merged = _lib.merge_intervals([(3, 4), (0, 1), (0.5, 2)])
    assert merged == [(0, 2), (3, 4)]
    assert _lib.busy_within(merged, 1.0, 3.5) == pytest.approx(1.5)


@pytest.mark.parametrize("busy,window,want", [(0.75, 1.0, 25.0), (0.0, 1.0, None),
                                              (1.0, 0.0, None)])
def test_idle_pct(busy, window, want):
    got = _lib.idle_pct(busy, window)
    assert got == (None if want is None else pytest.approx(want))


def test_recall_hits():
    ids = torch.tensor([[1, 2, 3], [4, 5, -1], [7, 7, 7]])
    truth = torch.tensor([[3, 2, 9], [5, 4, 6], [7, 8, 9]])
    assert _lib.recall_hits(ids, truth) == 5      # a repeated answer hits once


HOP = "void gather_distance_hop_kernel<0, 4, true>"


def _timeline():
    return _lib.Timeline(
        device=[(1.0, 2.0, HOP), (1.5, 2.5, "where"), (3.0, 3.5, HOP), (6.0, 7.0, "late")],
        host=[(0.5, 4.0, "aten::outer"), (2.6, 2.9, "aten::item")],
        spans=[(0.2, 4.5, "annbench.Searcher.search")], window=(0.0, 5.0))


def test_timeline_busy_ops_and_gaps():
    tl = _timeline()
    assert tl.window_s == 5.0
    assert tl.busy_s() == pytest.approx(2.0)        # the op past the window is left out
    assert tl.op_seconds(_lib.HOP_KERNEL) == (pytest.approx(1.5), 2)
    assert tl.top_ops() == [[HOP, 1.5], ["where", 1.0]]
    gaps = dict(tl.idle_gaps())
    assert gaps == {"annbench.Searcher.search": pytest.approx(1.5),
                    "annbench.Searcher.search > aten::outer": pytest.approx(1.0),
                    "annbench.Searcher.search > aten::item": pytest.approx(0.5)}
    assert sum(gaps.values()) == pytest.approx(tl.window_s - tl.busy_s())


def _obs():
    search = {"batches": 2, "rows": 20, "steps": [3, 5], "comps": 400, "wall_s": 0.016}
    traced = dict(search, R=4, E=2, d=8)
    return {"search": search,
            "builds": {"count": 2, "construct_s": [2.0, 3.0], "diversify_s": [0.1, 0.3]},
            "trace": {"timeline": _timeline(), "search": traced, "build": {}}}


def _expected():
    # hop launches: 2 seed scorings + 8 steps; slots 20 * 2 + 10 * 4 * 8
    nbytes = _lib.hop_bytes(400, 20 * 2 + 10 * 4 * 8, 4, 8)
    return {"beam_steps": 4.0, "step_ms": 2.0, "comps_per_query": 20.0,
            "gather_distance_hop_roofline": 100 * nbytes / _lib.HBM_BYTES_PER_S / (1.5 * 10 / 2),
            "device_idle_pct.search": 60.0, "device_idle_pct.build": 60.0,
            "construct_s": 2.5, "diversify_s": 0.2}


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_reader(name):
    read = harness.load_reader(ROOT, name)
    assert read(_obs()) == pytest.approx(_expected()[name])
    assert read({}) is None            # nothing to read: no value, never a made-up 0


def test_hop_roofline_is_silent_when_the_profiler_kept_no_launch():
    obs = _obs()
    obs["trace"]["timeline"] = _lib.Timeline(window=(0.0, 1.0))
    assert harness.load_reader(ROOT, "gather_distance_hop_roofline")(obs) is None
