"""Continuous-batching ANN query server on the PyTorch port, as the
reference's ``src/repro/launch/server.py``:

    submit() ──> request queue ──> bucket pad ──> admission ──> beam core
       │            (shed past       (smallest      (<= max_live
       │          max_queue_depth)   bucket that     batches in
       │                             fits, q_valid   flight)
       └── timestamps: enqueue ─ admit ─ dispatch ─ complete

* **Buckets.** Each request is padded up to the smallest configured bucket
  that fits. Seeding runs on the request's real rows with the request's
  int ``seed``; then the queries are padded with zeros, the entries with
  ``INVALID`` and the entry comps with 0, and ``q_valid`` masks the pad
  rows out of the beam (zero comparisons). The same seed rides into the
  search: restart keys and filter redraws are functions of the row index,
  and the pq scorer's LUTs are built in fixed blocks of rows
  (``engine.SCORER_BLOCK``), so a served request is bit-identical to
  ``Searcher.search`` on its own rows with its seed.
* **Admission control.** At most ``max_live_batches`` dispatched and
  unretired batches; past ``max_queue_depth`` queued requests a submit is
  shed (recorded, never dispatched).
* **Readiness.** ``_admit`` records a ``torch.cuda.Event`` after the
  dispatch; ``_ready`` queries it and ``_retire`` synchronises on it. A
  CPU result is ready when it returns. The port's beam loop reads
  ``done.all()`` once a step on the host, so ``_admit`` returns only when
  the batch's loop has finished: the live window seldom holds more than
  one batch (``stats()["max_live"]`` reports the largest it held).
* **Hot swap.** ``swap()`` prepares and warms the incoming index off the
  serving path, then flips two attributes. In-flight batches hold their
  own result tensors; queued requests are answered by the new version.
  ``prepared_state`` lists what a request could still build or load
  (kernel libraries, strategy aux, PQ / sq8 tables, base stores, compiled
  filters): a warmed index shows the same list after serving as at the
  flip.
* **Per-request filters.** ``submit(..., filter=FilterSpec(...))``
  restricts that request to a metadata predicate; the compiled filter is
  cached per value on the Searcher.

No thread is used. Drive it with ``submit``/``poll`` (open loop, shedding)
or ``submit_wait``/``drain`` (closed loop, backpressure);
``repro_torch.launch.loadgen`` does both.
"""
from __future__ import annotations

import bisect
import time
from collections import deque
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.beam_search import SearchResult
from ..core.engine import Searcher, SearchSpec, _fold
from ..core.filters import FilterSpec
from ..core.topk import INVALID


class ServeConfig(NamedTuple):
    """Static serving-layer configuration (the knobs around one SearchSpec)."""

    buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    max_live_batches: int = 4   # admission cap: dispatched, not yet retired
    max_queue_depth: int = 64   # shed submits beyond this backlog


@dataclass
class Request:
    """One client request: a (q, d) block of host query rows, its int seed,
    and its latency trail. ``shed`` requests never reach the device."""

    rid: int
    queries: np.ndarray
    seed: int
    t_enqueue: float
    t_admit: float | None = None
    t_dispatch: float | None = None
    t_complete: float | None = None
    bucket: int | None = None
    shed: bool = False
    filter: FilterSpec | None = None
    ids: np.ndarray | None = None            # (q, k) answers, real rows only
    dists: np.ndarray | None = None          # (q, k)
    n_comps: np.ndarray | None = None        # (q,)
    bytes_touched: np.ndarray | None = None  # (q,) scored + rerank bytes

    @property
    def latency_s(self) -> float:
        return self.t_complete - self.t_enqueue

    @property
    def queue_wait_s(self) -> float:
        return self.t_admit - self.t_enqueue


class _LiveBatch(NamedTuple):
    request: Request
    result: SearchResult
    event: torch.cuda.Event | None   # recorded after the dispatch (cuda only)


def _percentiles(ms: np.ndarray) -> dict:
    return {
        "p50_ms": round(float(np.percentile(ms, 50)), 3),
        "p90_ms": round(float(np.percentile(ms, 90)), 3),
        "p99_ms": round(float(np.percentile(ms, 99)), 3),
        "mean_ms": round(float(ms.mean()), 3),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepared_state(searcher: Searcher) -> dict:
    """What a request on ``searcher`` could still build or load: the loaded
    kernel libraries and the Searcher's per-index state. Equal before and
    after a stream of requests means the stream built and loaded nothing."""
    from ..kernels import _build

    return {
        "libraries": sorted(_build._LIBS),
        "aux": sorted(searcher._aux, key=repr),
        "pq": sorted(searcher._pq),
        "sq8": searcher._sq8 is not None,
        "stores": sorted(searcher._stores),
        "filter_compiles": searcher.filter_compiles,
    }


class AnnServer:
    """Continuous-batching front end over one :class:`Searcher` + spec
    (module docstring)."""

    def __init__(self, searcher: Searcher, spec: SearchSpec,
                 config: ServeConfig = ServeConfig(),
                 clock=time.monotonic):
        if not config.buckets or list(config.buckets) != sorted(
                set(config.buckets)) or config.buckets[0] < 1:
            raise ValueError(
                f"buckets must be sorted unique positive sizes, got "
                f"{config.buckets!r}"
            )
        if config.max_live_batches < 1 or config.max_queue_depth < 1:
            raise ValueError("max_live_batches and max_queue_depth must be "
                             ">= 1")
        self.searcher = searcher
        self.spec = spec
        self.config = config
        self.clock = clock
        self.queue: deque[Request] = deque()
        self.live: deque[_LiveBatch] = deque()
        self.completed: list[Request] = []
        self.shed: list[Request] = []
        self._rid = 0
        self.bucket_counts = {b: 0 for b in config.buckets}
        self.real_rows = 0
        self.padded_rows = 0
        self.max_live = 0
        # hot-swap bookkeeping: the serving index version, bumped by every
        # flip, and the flip event log
        self.version = 0
        self.swap_events: list[dict] = []
        self._prepare_index(searcher, spec)

    @staticmethod
    def _prepare_index(searcher: Searcher, spec: SearchSpec) -> None:
        """Per-index state built once, off the serving path: strategy aux,
        PQ or sq8 table, host/disk base store."""
        searcher.prepare(spec)
        if spec.scorer == "pq":
            searcher.pq_index(spec)
        elif spec.scorer == "sq8":
            searcher.sq8_index()
        if spec.base_placement != "device":
            searcher.base_store(spec.base_placement, spec.store_dtype)

    # -- bucketing ------------------------------------------------------------

    def pick_bucket(self, q: int) -> int:
        """Smallest configured bucket that fits a q-row request."""
        if q < 1:
            raise ValueError(f"request must carry >= 1 query row, got {q}")
        i = bisect.bisect_left(self.config.buckets, q)
        if i == len(self.config.buckets):
            raise ValueError(
                f"request of {q} rows exceeds the largest bucket "
                f"{self.config.buckets[-1]}; split it client-side or widen "
                f"ServeConfig.buckets"
            )
        return self.config.buckets[i]

    def warmup(self, seed: int | None = None, *,
               searcher: Searcher | None = None,
               spec: SearchSpec | None = None) -> None:
        """Run every request shape the serving path can hit, off the serving
        path: each qn in 1..max bucket once (and again with a one-id deny
        filter when the index has metadata or the spec filters). This loads
        every kernel library of the path and builds the per-index state
        (strategy aux, PQ or sq8 table, base store, the compiled filter).
        ``searcher``/``spec`` (default: the serving pair) let :meth:`swap`
        warm an incoming index before the flip."""
        searcher = self.searcher if searcher is None else searcher
        spec = self.spec if spec is None else spec
        d = searcher.base.shape[1]
        seed = searcher.rng_seed if seed is None else seed
        b_max = self.config.buckets[-1]
        rows = np.random.default_rng(_fold(seed, b_max)).standard_normal(
            (b_max, d), dtype=np.float32)
        warm_filter = searcher.metadata is not None or spec.filter is not None
        for qn in range(1, b_max + 1):
            filters = (None, FilterSpec(deny_ids=(0,))) if warm_filter else (None,)
            for f in filters:
                self._search_padded(rows[:qn], _fold(seed, 2 * qn), self.pick_bucket(qn),
                                    searcher=searcher, spec=spec, filter=f)
                _sync(searcher.device)

    # -- the padded core call -------------------------------------------------

    def _search_padded(self, rows: np.ndarray, seed: int, bucket: int, *,
                       searcher: Searcher | None = None,
                       spec: SearchSpec | None = None,
                       filter: FilterSpec | None = None) -> SearchResult:
        """Copy + seed + pad + search. Seeding uses the request's real rows
        and ``seed``; padding to the bucket follows, with entries INVALID,
        comps 0 and ``q_valid`` masking the pad rows. ``filter`` overrides
        ``spec.filter`` for this request."""
        searcher = self.searcher if searcher is None else searcher
        spec = self.spec if spec is None else spec
        if filter is not None:
            spec = spec._replace(filter=filter)
        qn, d = rows.shape
        dev = searcher.device
        q = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(dev)
        ent, ecomps = searcher.seed(q, spec, seed)
        pad = bucket - qn
        if pad:
            q = torch.cat([q, q.new_zeros((pad, d))])
            ent = torch.cat([ent, ent.new_full((pad, ent.shape[1]), INVALID)])
            ecomps = torch.cat([ecomps, ecomps.new_zeros((pad,))])
        valid = torch.arange(bucket, device=dev) < qn
        return searcher.search(q, spec, seed, entries=ent, entry_comps=ecomps,
                               q_valid=valid)

    # -- hot swap -------------------------------------------------------------

    def swap(self, searcher: Searcher, spec: SearchSpec | None = None,
             seed: int | None = None) -> int:
        """Flip serving to a new index version with zero dropped requests:
        prepare and warm the incoming index first (off the serving path),
        then two attribute assignments. Returns the new version number."""
        spec = self.spec if spec is None else spec
        self._prepare_index(searcher, spec)
        t0 = self.clock()
        self.warmup(seed, searcher=searcher, spec=spec)   # pre-flip: off-path
        warmed = self.clock()
        # the flip: every request admitted after this line runs on v+1
        self.searcher = searcher
        self.spec = spec
        self.version += 1
        self.swap_events.append({
            "version": self.version,
            "n": int(searcher.base.shape[0]),
            "warm_s": round(warmed - t0, 4),
            "t_flip": self.clock(),
            "live_at_flip": len(self.live),
            "queued_at_flip": len(self.queue),
        })
        return self.version

    # -- request lifecycle ----------------------------------------------------

    def submit(self, rows, seed: int | None = None, now: float | None = None,
               advance: bool = True, filter: FilterSpec | None = None) -> Request:
        """Enqueue one request (open loop). If the queue is at
        ``max_queue_depth`` the request is shed: marked and recorded, never
        dispatched. ``advance=False`` enqueues without driving :meth:`poll`
        (an open-loop client behind schedule). The default seed is
        ``_fold(searcher.rng_seed, 1_000_003 + rid)``."""
        now = self.clock() if now is None else now
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2:
            raise ValueError(f"rows must be (q, d), got shape {rows.shape}")
        rid = self._rid
        self._rid += 1
        if seed is None:
            seed = _fold(self.searcher.rng_seed, 1_000_003 + rid)
        req = Request(rid=rid, queries=rows, seed=seed, t_enqueue=now, filter=filter)
        req.bucket = self.pick_bucket(rows.shape[0])  # reject-too-big first
        if len(self.queue) >= self.config.max_queue_depth:
            req.shed = True
            self.shed.append(req)
            return req
        self.queue.append(req)
        if advance:
            self.poll(now)
        return req

    def submit_wait(self, rows, seed: int | None = None,
                    filter: FilterSpec | None = None) -> Request:
        """Closed-loop submit: when the queue is full, retire the oldest
        in-flight batch instead of shedding (backpressure)."""
        while len(self.queue) >= self.config.max_queue_depth:
            if self.live:
                self._retire(self.live.popleft())
            self.poll()
        return self.submit(rows, seed, filter=filter)

    def poll(self, now: float | None = None) -> None:
        """Retire finished batches from the head of the live window (one
        stream: dispatch order is completion order), then admit queued
        requests up to the admission cap."""
        while self.live and self._ready(self.live[0]):
            self._retire(self.live.popleft())
        while self.queue and len(self.live) < self.config.max_live_batches:
            self._admit(self.queue.popleft())

    def drain(self) -> list[Request]:
        """Block until every queued and in-flight request completes."""
        while self.live or self.queue:
            if self.live:
                self._retire(self.live.popleft())
            self.poll()
        return self.completed

    def _ready(self, lb: _LiveBatch) -> bool:
        return True if lb.event is None else bool(lb.event.query())

    def _admit(self, req: Request) -> None:
        req.t_admit = self.clock()
        res = self._search_padded(req.queries, req.seed, req.bucket, filter=req.filter)
        event = None
        if self.searcher.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        req.t_dispatch = self.clock()
        qn = req.queries.shape[0]
        self.bucket_counts[req.bucket] += 1
        self.real_rows += qn
        self.padded_rows += req.bucket - qn
        self.live.append(_LiveBatch(req, res, event))
        self.max_live = max(self.max_live, len(self.live))

    def _retire(self, lb: _LiveBatch) -> None:
        res, req = lb.result, lb.request
        if lb.event is not None:
            lb.event.synchronize()
        req.t_complete = self.clock()
        qn = req.queries.shape[0]
        req.ids = res.ids[:qn].cpu().numpy()
        req.dists = res.dists[:qn].cpu().numpy()
        req.n_comps = res.n_comps[:qn].cpu().numpy()
        bt = res.bytes_touched
        req.bytes_touched = bt[:qn].cpu().numpy() if bt.ndim else None
        self.completed.append(req)

    # -- rollups --------------------------------------------------------------

    def stats(self) -> dict:
        """Latency profile + occupancy over everything completed so far."""
        out = {
            "completed": len(self.completed),
            "shed": len(self.shed),
            "version": self.version,
            "swaps": len(self.swap_events),
            "bucket_counts": {str(b): c for b, c in
                              self.bucket_counts.items() if c},
            "real_rows": self.real_rows,
            "padded_rows": self.padded_rows,
            "mean_fill": round(
                self.real_rows / max(self.real_rows + self.padded_rows, 1), 4
            ),
            "max_live": self.max_live,
        }
        if self.completed:
            lat = np.array([r.latency_s for r in self.completed]) * 1e3
            out.update(_percentiles(lat))
            waits = np.array([r.queue_wait_s for r in self.completed]) * 1e3
            out["mean_queue_ms"] = round(float(waits.mean()), 3)
            span = (max(r.t_complete for r in self.completed)
                    - min(r.t_enqueue for r in self.completed))
            out["sustained_qps"] = round(self.real_rows / max(span, 1e-9), 1)
        return out
