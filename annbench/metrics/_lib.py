"""The benchmark's metric arithmetic and its reading of the profiler.

Per-layer readers (``metrics/<name>.py``) read an observation dict that the
harness and the traffic driver fill: host-clock counters of the window,
the program's own counts (``SearchResult.n_comps`` / ``n_steps``,
``BuildReport`` walls) and, in a ``--trace 1`` run, a :class:`Timeline` of a
short profiled window. The byte count of the beam's hop kernel is the
benchmark's own, from ``n_comps`` and d, so that the program cannot move it.
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

# published H100 SXM peak HBM3 bandwidth (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
# the beam's masked hop (kernels/csrc/gather_distance.cu), as the profiler names it
HOP_KERNEL = "gather_distance_hop_kernel"
SPAN_PREFIX = "annbench."
WINDOW_SPAN = "annbench.window"
# quiet time at each end of a profiled window: the profiler keeps only device
# events that fall inside its window, and on the H100 it has lost windows
# whose events fell just outside the window's ends after heavy work
WINDOW_PAD_S = 0.05
# device op names in a breakdown are cut to this many characters (CUDA
# template names run to hundreds)
NAME_CHARS = 96


def hop_bytes(n_comps: int, slots: int, R: int, d: int) -> int:
    """Least HBM bytes of the hop kernel's launches: every scored id's float
    row (4 d) and visited word (4); every (query, slot) pair's id read (4)
    and its two outputs (dist and id, 8); a query's row (4 d) once in each
    launch that scores one of its ids. A launch scores at most R ids of a
    row, so a query with c scored ids is read in at least c / R launches:
    rows frozen for the rest of a batch, whose slots are all padding, read
    nothing. Each byte once; padding slots read no row."""
    return n_comps * (4 * d + 4) + slots * 12 + -(-n_comps // R) * 4 * d


def roofline_pct(nbytes: float, device_s: float, peak: float = HBM_BYTES_PER_S) -> float | None:
    """Share (%) of the least time, bytes over peak bandwidth, in the
    measured device time; None where no device time was measured."""
    if device_s <= 0:
        return None
    return 100.0 * (nbytes / peak) / device_s


def merge_intervals(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_within(merged, lo: float, hi: float) -> float:
    """Length of the merged intervals inside [lo, hi]."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


def idle_pct(busy_s: float, window_s: float) -> float | None:
    """Share (%) of a window with nothing running on the device; None
    where the window recorded no device time (never a made-up 0)."""
    if busy_s <= 0 or window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / window_s)


def recall_hits(ids, truth) -> int:
    """How many of each row's true neighbours ``truth`` (m, k) are among
    its answers ``ids`` (m, k), each true neighbour once however often it
    is answered, summed over the rows. recall@k = hits / (m k)."""
    return int((truth[:, :, None] == ids[:, None, :]).any(2).sum())


@dataclass
class Timeline:
    """A profiled window, in seconds on the profiler's clock: device ops
    (start, end, name), host ops (start, end, name) and the harness's spans
    (start, end, name), with the window's own span."""

    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return busy_within(merge_intervals((s, e) for s, e, _ in self.device), *self.window)

    def op_seconds(self, match: str | None = None) -> tuple[float, int]:
        """(seconds, launches) of the device ops inside the window whose
        name contains ``match`` (all where None)."""
        lo, hi = self.window
        sel = [(s, e) for s, e, name in self.device
               if (match is None or match in name) and s >= lo and e <= hi]
        return sum(e - s for s, e in sel), len(sel)

    def top_ops(self, top: int = 10) -> list:
        """The device ops that took most time: [[name, seconds], ...]."""
        lo, hi = self.window
        by: dict[str, float] = {}
        for s, e, name in self.device:
            if s >= lo and e <= hi:
                by[name] = by.get(name, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle time inside the window by what the host was doing at each
        gap's midpoint (the innermost harness span, then the innermost host
        op): [[label, seconds], ...], the largest sums first."""
        lo, hi = self.window
        merged = [(max(s, lo), min(e, hi)) for s, e in
                  merge_intervals((s, e) for s, e, _ in self.device) if e > lo and s < hi]
        gaps, cur = [], lo
        for s, e in merged:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if hi > cur:
            gaps.append((cur, hi))
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by: dict[str, float] = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            label = self._innermost(self.spans, mid) or "outside spans"
            i = bisect.bisect_right(starts, mid)
            for j in range(i - 1, max(i - 65, -1), -1):
                hs, he, name = host[j]
                if he >= mid:
                    label += " > " + name
                    break
            by[label] = by.get(label, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    @staticmethod
    def _innermost(spans, t: float) -> str | None:
        inside = [(s, name) for s, e, name in spans if s <= t <= e and name != WINDOW_SPAN]
        return max(inside)[1] if inside else None


def _timeline(prof) -> Timeline:
    """The window, device ops, host ops and harness spans of a finished
    torch.profiler run (FunctionEvent times are microseconds)."""
    import torch

    tl = Timeline()
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        name = e.name
        annotation = getattr(e, "is_user_annotation", False) or name.startswith(SPAN_PREFIX)
        if e.device_type == cuda:
            if not annotation:
                tl.device.append((s, t, name[:NAME_CHARS]))
        elif name == WINDOW_SPAN:
            tl.window = (s, t)
        elif name.startswith(SPAN_PREFIX):
            tl.spans.append((s, t, name))
        else:
            tl.host.append((s, t, name))
    return tl


def profile_window(fn, tries: int = 3, log=None):
    """``fn()`` under torch.profiler (CPU and CUDA activities) inside the
    ``annbench.window`` span, padded with WINDOW_PAD_S of quiet time at both
    ends. A window in which the profiler recorded no device time is taken
    again, up to ``tries`` windows (as ``chip_smoke.py``'s
    ``device_events``). Returns (fn's last result, Timeline); the Timeline's
    device list is empty where every window was lost."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    tl, res = Timeline(), None
    for attempt in range(tries):
        sync()
        with profile(activities=activities) as prof:
            time.sleep(WINDOW_PAD_S)
            with record_function(WINDOW_SPAN):
                res = fn(attempt)
                sync()
            time.sleep(WINDOW_PAD_S)
        tl = _timeline(prof)
        if tl.busy_s() > 0:
            return res, tl
        if log is not None:
            log(f"the profiler recorded no device time in window {attempt + 1} of {tries}")
    return res, Timeline(window=tl.window)
