"""The readers of the program's own spans (``metrics/_spans.py`` and the
five metrics that read it): where they give nothing, how they find a
span's children, and a traced CPU run of each cell that reports them."""
import json
from pathlib import Path

import pytest

from annbench import harness
from annbench import test_annbench_metrics as accepted
from annbench.metrics import _lib

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEARCH = ("step_launch_ms", "step_wait_ms")
BUILD = ("nd_round_ms", "nd_rounds", "build_report_s")
P = "repro_torch."


def _read(name, obs):
    return harness.load_reader(ROOT, name)(obs)


def _step(s, run, wait):
    """A beam step span at ``s``: ``run`` s of launches, then ``wait`` s in
    its ``beam.done``."""
    return [(s, s + run + wait, P + "beam.step"), (s + run, s + run + wait, P + "beam.done")]


def _search_obs(host, steps, window=(0.0, 10.0)):
    tl = _lib.Timeline(host=host, window=window)
    return {"trace": {"timeline": tl, "search": {"steps": steps}}}


def _build_obs(host, count=1, window=(0.0, 10.0)):
    tl = _lib.Timeline(host=host, window=window)
    return {"trace": {"timeline": tl, "build": {"count": count}}}


def test_two_steps_each_with_its_own_done():
    # step 1: 0.2 s issuing, 0.6 s waiting; step 2: 0.4 s and 0.2 s; a
    # done outside every step is no step's wait
    host = _step(1.0, 0.2, 0.6) + _step(3.0, 0.4, 0.2) + [(5.0, 5.5, P + "beam.done")]
    obs = _search_obs(host, [2])
    assert _read("step_launch_ms", obs) == pytest.approx(300.0)
    assert _read("step_wait_ms", obs) == pytest.approx(400.0)


def test_a_lost_step_span_reads_nothing():
    obs = _search_obs(_step(1.0, 0.2, 0.6) + _step(3.0, 0.4, 0.2), [3])
    assert all(_read(name, obs) is None for name in SEARCH)


def test_a_span_outside_the_window_is_not_counted():
    host = _step(1.0, 0.2, 0.6) + _step(9.5, 0.4, 0.2)       # the second ends at 10.1
    assert all(_read(name, _search_obs(host, [2])) is None for name in SEARCH)
    assert _read("step_launch_ms", _search_obs(host, [1])) == pytest.approx(200.0)


def test_no_trace_reads_nothing():
    for name in SEARCH + BUILD:
        assert _read(name, {}) is None
        assert _read(name, {"search": {"steps": [3]}, "builds": {"count": 1}}) is None


def test_build_spans_are_counted_inside_their_builds():
    host = [(1.0, 5.0, P + "build"), (6.0, 9.0, P + "build"), (0.2, 0.5, P + "nndescent.round")]
    for lo in (1.0, 6.0):
        host += [(lo + 0.1, lo + 0.5, P + "nndescent.round"), (lo + 0.5, lo + 0.7,
                 P + "nndescent.round"), (lo + 1.0, lo + 1.5, P + "build.proxy"),
                 (lo + 2.0, lo + 2.5, P + "build.report")]
    obs = _build_obs(host, count=2)
    assert _read("nd_rounds", obs) == pytest.approx(2.0)
    assert _read("nd_round_ms", obs) == pytest.approx(300.0)
    assert _read("build_report_s", obs) == pytest.approx(1.0)
    assert all(_read(name, _build_obs(host, count=3)) is None for name in BUILD)


def _program_spans():
    """The program's spans in the window of the reader test's hand-made
    timeline (``test_annbench_metrics._timeline``): 8 beam steps of 0.3 s,
    each ending in a 0.1 s ``beam.done``; one build with 3 NN-Descent
    rounds of 0.5 s, a 0.25 s proxy and a 0.5 s report."""
    out = []
    for i in range(8):
        s = 0.5 + 0.5 * i
        out += [(s, s + 0.3, P + "beam.step"), (s, s + 0.05, P + "beam.select"),
                (s + 0.2, s + 0.3, P + "beam.done")]
    out.append((0.1, 4.9, P + "build"))
    for i in range(3):
        s = 0.2 + 0.6 * i
        out += [(s, s + 0.5, P + "nndescent.round"), (s + 0.45, s + 0.5, P + "nndescent.done")]
    out += [(2.1, 2.35, P + "build.proxy"), (4.0, 4.5, P + "build.report")]
    return out


EXPECTED = {"step_launch_ms": 200.0, "step_wait_ms": 100.0,
            "nd_round_ms": 500.0, "nd_rounds": 3.0, "build_report_s": 0.75}


@pytest.mark.parametrize("name", SEARCH + BUILD)
def test_reader_on_the_reader_tests_inputs(name):
    """Each new reader on ``test_annbench_metrics._obs()`` (whose search
    counts 3 + 5 steps) with the program's spans added to its timeline and
    the traced build counted; without them it reads nothing."""
    obs = accepted._obs()
    assert _read(name, obs) is None
    obs["trace"]["timeline"].host += _program_spans()
    obs["trace"]["build"]["count"] = 1
    assert _read(name, obs) == pytest.approx(EXPECTED[name])


@pytest.fixture
def device_in_each_window(monkeypatch):
    """The CPU records no device time, and the harness keeps a profiled
    window only where the device recorded some (``_lib.profile_window``):
    here each window gets one stand-in device op over its whole length, so
    that the CPU run keeps its host spans as a card's run does."""
    timeline = _lib._timeline

    def with_device(prof):
        tl = timeline(prof)
        tl.device.append((*tl.window, "stand-in device op"))
        return tl
    monkeypatch.setattr(_lib, "_timeline", with_device)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_cpu_run_reports_the_program_spans(cell, run_small, device_in_each_window):
    rc, r, _ = run_small(cell, trace=True)
    assert rc == 0 and r["correct"]
    names = SEARCH if cell.endswith(".search") else BUILD
    got = {name: r["metrics"][name]["value"] for name in names}
    assert all(v > 0 for v in got.values()), got
    assert not any(name.startswith(P) for name, _ in r["breakdown"]["device_ops"])


@pytest.mark.cuda
def test_on_the_card_the_spans_stay_on_the_host(cuda_device):
    """CUPTI records a device-side range for each span too; the timeline
    keeps the host side only, so no span counts as device busy time."""
    import torch

    from repro_torch.core.build import BuildSpec, GraphBuilder
    from repro_torch.core.engine import Searcher

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    base = torch.rand((4000, 16), generator=gen, device=cuda_device)

    def run(attempt):
        built = GraphBuilder(BuildSpec(graph_k=10, nd_rounds=4)).build(base, seed=2)
        searcher = Searcher.from_build(base, built, rng_seed=3)
        spec = searcher.spec(ef=32, k=10, entry="random", n_entries=4)
        return built.report, searcher.search(base[:256], spec, seed=4)

    (report, res), tl = _lib.profile_window(run)
    assert tl.busy_s() > 0
    assert not any(name.startswith(P) for _, _, name in tl.device)
    host = [name for _, _, name in tl.host]
    assert host.count(P + "beam.step") == host.count(P + "beam.done") == int(res.n_steps)
    assert host.count(P + "nndescent.round") == report.rounds
