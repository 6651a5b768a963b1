"""The program's spans (``repro_torch.tracing``): nothing entered with no
profiler running, the same results with one running, and the spans a search
and a build record, each where the loop's own counts say."""
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core.build import BuildSpec, GraphBuilder
from repro_torch.core.engine import Searcher
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

P = tracing.PREFIX
STEP_PHASES = ("select", "expand", "score", "visit", "merge", "freeze", "done")
ROUND_PHASES = ("pool", "score", "push", "merge", "done")
STAGES = ("construct", "proxy", "diversify", "compress", "report")
SPEC = BuildSpec(graph_k=10, nd_rounds=6, proxy_sample=32, lid_sample=32)
SEARCHES = {"fixed": {}, "stable_restarts": {"term": "stable", "stable_steps": 3,
                                             "restarts": 1}}


def _base(n=1500, d=8, seed=0):
    return torch.rand((n, d), generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def searcher():
    base = _base()
    return Searcher.from_build(base, GraphBuilder(SPEC).build(base, seed=3), rng_seed=5)


def _search(searcher, **kw):
    queries = _base(64, seed=1)
    spec = searcher.spec(ef=24, k=5, entry="random", n_entries=4, **kw)
    return searcher.search(queries, spec, seed=7)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.time_range.start, e.time_range.end, e.name[len(P):])
             for e in prof.events() if e.name.startswith(P)]
    return out, sorted(spans)


def _inside(parent, spans, name):
    s, e, _ = parent
    return [x for x in spans if x[2] == name and s <= x[0] and x[1] <= e]


def _named(spans, name):
    return [x for x in spans if x[2] == name]


def test_no_profiler_enters_no_record_function(monkeypatch, searcher):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")
    monkeypatch.setattr(autograd_profiler, "record_function", refused)
    assert not autograd_profiler._is_profiler_enabled
    with tracing.span("beam.step") as entered:
        assert entered is None
    assert tracing.span("a") is tracing.span("b")           # one shared no-op
    res = _search(searcher)
    GraphBuilder(SPEC).build(_base(400), seed=1)
    assert int(res.n_steps) > 0


def test_a_profiler_enters_the_named_span():
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(tracing.span("x"), autograd_profiler.record_function)


@pytest.mark.parametrize("kw", list(SEARCHES.values()), ids=list(SEARCHES))
def test_search_is_bit_identical_under_the_profiler(searcher, kw):
    plain = _search(searcher, **kw)
    traced, _ = _profiled(lambda: _search(searcher, **kw))
    assert torch.equal(plain.ids, traced.ids)
    assert torch.equal(plain.dists, traced.dists)
    assert torch.equal(plain.n_comps, traced.n_comps)
    assert int(plain.n_steps) == int(traced.n_steps) > 0


def test_build_is_bit_identical_under_the_profiler():
    base = _base()
    plain = GraphBuilder(SPEC).build(base, seed=11)
    traced, _ = _profiled(lambda: GraphBuilder(SPEC).build(base, seed=11))
    assert torch.equal(plain.graph.neighbors, traced.graph.neighbors)
    assert plain.report.rounds == traced.report.rounds
    assert plain.report.update_curve == traced.report.update_curve
    assert torch.equal(plain.hubs, traced.hubs)


@pytest.mark.parametrize("kw", list(SEARCHES.values()), ids=list(SEARCHES))
def test_a_search_records_one_step_span_a_step(searcher, kw):
    res, spans = _profiled(lambda: _search(searcher, **kw))
    (search,) = _named(spans, "search")
    for name in ("search.entries", "search.scorer_state", "beam.seed", "beam.finalize"):
        assert len(_inside(search, spans, name)) == 1, name
    steps = _named(spans, "beam.step")
    assert len(steps) == int(res.n_steps) > 0
    for step in steps:
        for phase in STEP_PHASES:
            assert len(_inside(step, spans, "beam." + phase)) == 1, phase
        (done,) = _inside(step, spans, "beam.done")
        assert done[0] >= max(x[1] for x in _inside(step, spans, "beam.freeze"))
    assert len(_named(spans, "beam.done")) == len(steps)


def test_a_build_records_its_rounds_and_stages():
    res, spans = _profiled(lambda: GraphBuilder(SPEC).build(_base(), seed=2))
    (build,) = _named(spans, "build")
    for stage in STAGES:
        assert len(_inside(build, spans, "build." + stage)) == 1, stage
    (construct,) = _inside(build, spans, "build.construct")
    assert len(_inside(construct, spans, "nndescent.init")) == 1
    rounds = _inside(construct, spans, "nndescent.round")
    assert len(rounds) == res.report.rounds > 0
    for rnd in rounds:
        for phase in ROUND_PHASES:
            assert len(_inside(rnd, spans, "nndescent." + phase)) == 1, phase
    (diversify,) = _inside(build, spans, "build.diversify")
    for name in ("gd.prune", "gd.union"):
        assert len(_inside(diversify, spans, name)) == 1, name
