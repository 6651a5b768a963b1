"""The program's own spans in a traced window, shared by the readers of
its phases: the host-side ranges that ``repro_torch.tracing.span`` records
under the profiler (``repro_torch.<name>``), which ``_lib._timeline`` keeps
among the timeline's host ops. A child is found inside its parent by
interval containment. Each reader gives None where the run has no trace,
or where the spans it counts disagree with the traffic's own count."""
from __future__ import annotations

import bisect

PREFIX = "repro_torch."


def spans(tl, name: str) -> list[tuple[float, float]]:
    """(start, end) of the host spans ``repro_torch.<name>`` that lie
    inside the timeline's window, sorted by start."""
    lo, hi = tl.window
    full = PREFIX + name
    return sorted((s, e) for s, e, n in tl.host if n == full and lo <= s and e <= hi)


def children(parents, kids) -> list[list[tuple[float, float]]]:
    """For each parent interval, the intervals of ``kids`` (sorted by start)
    that lie inside it."""
    starts = [s for s, _ in kids]
    out = []
    for s, e in parents:
        i, j = bisect.bisect_left(starts, s), bisect.bisect_right(starts, e)
        out.append([k for k in kids[i:j] if k[1] <= e])
    return out


def seconds(intervals) -> float:
    return sum(e - s for s, e in intervals)


def step_split(obs):
    """(launch ms, wait ms) a beam step over the traced batches: a step
    span's time outside its ``beam.done`` read, and the time in it, each
    summed over the step spans and divided by their number. None unless
    there are as many step spans as the batches' ``n_steps`` add up to."""
    tr = obs.get("trace")
    if not tr or "search" not in tr:
        return None
    tl = tr["timeline"]
    steps = spans(tl, "beam.step")
    if not steps or len(steps) != sum(tr["search"]["steps"]):
        return None
    wait = sum(seconds(d) for d in children(steps, spans(tl, "beam.done")))
    return 1e3 * (seconds(steps) - wait) / len(steps), 1e3 * wait / len(steps)


def build_phases(obs, name: str):
    """(the traced builds' count, the spans ``name`` inside their ``build``
    spans). None unless there are as many ``build`` spans as the traffic
    counted builds."""
    tr = obs.get("trace")
    if not tr or "build" not in tr:
        return None
    tl = tr["timeline"]
    builds = spans(tl, "build")
    if not builds or len(builds) != tr["build"].get("count"):
        return None
    return len(builds), [k for ks in children(builds, spans(tl, name)) for k in ks]
