"""Streaming index mutation, as the reference's ``src/repro/core/mutable.py``.

:class:`MutableIndex` holds a flat graph index that takes inserts, deletes
and compactions:

* **insert** — beam search on the current graph finds ``insert_ef``
  candidates (dead ids masked by the tombstone bitmap), the inline
  ``diversify`` stage (``none``, ``gd`` or ``dpg``) picks the out-edges, and
  degree-capped reciprocal linking splices the new id into its neighbors'
  rows (the worst edge goes; a strict ``<``, so an incumbent wins a distance
  tie as the batch top-k's lowest-id rule does). With ``insert_ef=0`` the
  candidates come from an exact masked scan instead: full k-NN maintenance.
* **delete** — a tombstone bit and nothing else. The bitmap is every
  query's initial visited set (``beam_search(tombstones=...)``), so the hop
  kernels' mask epilogue drops dead ids at seeding and at every hop. Edges
  into dead vertices stay until compaction.
* **compact** — a batch build (``core.build.build_index``) of the surviving
  rows in their original id order; it reclaims dead and unallocated slots
  and resets the log. With the same spec and seed it equals a fresh build
  of the survivors bit for bit.

Storage is capacity-padded: host numpy arrays of ``capacity`` rows are
authoritative, with mirrors on the index's device. An insert writes its
rows into the mirrors in place (``index_copy_`` and word writes), so the
search shapes stay fixed until a capacity doubling; the adjacency rows an
insert touches are written before the next beam or search reads them.
Deleted slots are not reused; compaction reclaims them.

A :class:`~repro_torch.core.engine.Searcher` from :meth:`searcher` is a
snapshot, as the reference's is (its jax arrays are immutable): it answers
bit for bit as it did after any later insert, delete or flush. The mirrors
it holds (base, adjacency, tombstone words) are marked shared, and the
first write to a shared mirror clones it and writes the clone (copy on
write); the Searcher keeps the old tensor. Inserts with no ``searcher()``
call between them clone nothing, and ``searcher()`` copies nothing: it is
cached until the next mutation. ``cow_clones`` / ``cow_bytes`` count the
clones. The metadata columns are not cloned: an insert writes the row of
a slot that every older snapshot holds tombstoned, and a compiled filter
takes tombstoned rows out of its allowed set.

Exact-mode inserts equal a batch build bit for bit: both directions of the
scan hand ``distance_matrix`` a full (128, d) block holding the new point
in row 0, as the reference does for its reverse direction. On the CPU the
plain version's ``x @ y.T`` sends a one-row operand down MKL's
matrix-vector path, which sums in another order than the batch's
matrix-matrix product (thousands of differing entries at n=500; a two-row
operand still differs at d=64), and the block gives the batch's bits in
both directions. The card does not need the block: each entry of either
route is one ``fmaf`` chain over d with one epilogue whatever the
operand's shape (``chip_smoke.py`` phase 9: 0 of 2,000,000 entries differ
between the block and a one-row operand, both directions, on an NVIDIA
H100 80GB HBM3 at 700 W),
and the block's tile is the one a one-row operand is padded to. The block
stays on every device for the CPU's sake; on the card it costs the
(128, capacity) output: 1.07 / 0.97 ms against the one-row call's 0.76 /
0.96 ms (forward / reverse) at 2M rows.
So ``construct="incremental"`` with ``insert_ef=0`` equals
``construct="exact"`` at matched capacity.

Against the reference. An insert's entries are drawn from a
``torch.Generator`` seeded from ``(rng_seed, 0x1475 + total_inserts)``
where the reference folds the same count into its ``jax.random`` key, so
the draws differ; :meth:`insert` and :meth:`insert_batch` take explicit
``entries`` so the reference's draws can be injected. The tombstone words
are the reference's uint32 bits on the host and int32 words on the device
(``core.filters``). :meth:`state` / :meth:`from_state` carry the whole
state across (``core.convert.mutable_from_numpy`` takes the reference's).
The inline selects compute their candidate geometry on the index's device
(the GD pair matrix through ``ops.distance_matrix``) and run the greedy
selection of ``core.diversify`` on the host, where its per-slot loop costs
no kernel launches; the kept set is the same on either device.

The flat graph only: a hierarchy is a batch artifact, rebuilt at compaction
through the ``hnsw`` construct.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_device
from .beam_search import beam_search, random_entries
from .diversify import _angular_select, _occlusion_select
from .engine import Searcher, _fold
from .filters import pack_bitmap
from .graph_index import DEFAULT_N_HUBS, KnnGraph, hub_vertices
from .io import IndexArtifact, _np, save_index
from .topk import INVALID, topk_smallest

# the distance matrix's block: both scan directions hand the kernel a full
# pre-materialized block (see the module docstring)
SCAN_BLOCK = 128

INLINE_DIVERSIFIERS = ("none", "gd", "dpg")

# mixed with the insert count into an insert's entry seed (the reference's
# fold constant)
INSERT_FOLD = 0x1475

# the parts of an insert timed in ``part_s``: a capacity doubling, the
# exact scan (exact placement) or the beam and the inline select (beam
# placement), the reciprocal link on the host, and the writes into the
# device mirrors
INSERT_PARTS = ("grow", "scan", "beam", "select", "link", "writes")


def pack_tombstones(dead) -> np.ndarray:
    """(C,) bool dead mask -> (ceil(C/32),) packed uint32, bit ``i & 31`` of
    word ``i >> 5``: the beam's visited layout, as filter deny bitmaps."""
    return pack_bitmap(dead)


def _meta_fill(dtype) -> object:
    """Fill value of a metadata column's unset rows: NaN for float columns,
    -1 for integer ones (for unsigned dtypes it wraps to the maximum, still
    never a real id)."""
    return np.nan if np.issubdtype(dtype, np.floating) else -1


def _to(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a numpy array that never shares its memory."""
    a = np.ascontiguousarray(a)
    if device.type == "cpu" or not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    return t if device.type == "cpu" else t.to(device)


def _exact_scan(x: torch.Tensor, base: torch.Tensor, alive: torch.Tensor,
                metric: str):
    """Both distance directions of one insert, masked to alive rows:
    fwd[v] = d(x, v), the batch matrix's row of x, and rev[v] = d(v, x), its
    column, each through a (SCAN_BLOCK, d) block holding x in row 0."""
    from ..kernels import ops

    block = torch.zeros((SCAN_BLOCK, x.shape[0]), dtype=torch.float32, device=base.device)
    block[0] = x
    fwd = ops.distance_matrix(block, base, metric)[0]
    rev = ops.distance_matrix(base, block, metric)[:, 0]
    inf = torch.full_like(fwd, float("inf"))
    return torch.where(alive, fwd, inf), torch.where(alive, rev, inf)


def _gd_select(base: torch.Tensor, cand: np.ndarray, cand_d: np.ndarray,
               valid: np.ndarray, metric: str, max_keep: int) -> np.ndarray:
    """Inline GD: occlusion-prune one insert's (distance-sorted) beam
    candidates, the batch ``gd_prune`` body for one vertex. The (L, L) pair
    matrix is one ``ops.distance_matrix`` call on the device (x is y)."""
    from ..kernels import ops

    rows = base[torch.from_numpy(np.maximum(cand, 0).astype(np.int64)).to(base.device)]
    pd = ops.distance_matrix(rows, rows, metric).cpu()
    ok = torch.from_numpy(valid)
    pd = pd.masked_fill(~ok[:, None] | ~ok[None, :], float("inf"))
    keep = _occlusion_select(torch.from_numpy(cand_d)[None], pd[None], ok[None], max_keep)
    return keep[0].numpy()


def _dpg_select(base: torch.Tensor, x: torch.Tensor, cand: np.ndarray,
                valid: np.ndarray, max_keep: int) -> np.ndarray:
    """Inline DPG: angular max-min over one insert's candidate edge
    directions, the batch ``dpg_prune`` body for one vertex."""
    rows = base[torch.from_numpy(np.maximum(cand, 0).astype(np.int64)).to(base.device)]
    e = rows - x[None, :]
    e = e * torch.rsqrt(torch.clamp((e * e).sum(-1, keepdim=True), min=1e-12))
    cs = (e @ e.T).cpu()
    return _angular_select(cs[None], torch.from_numpy(valid)[None], max_keep)[0].numpy()


class MutableIndex:
    """A flat graph index under inserts, tombstone deletes and compaction
    (module docstring), on one device: ``device`` ("cuda" by default; raises
    without a GPU) or "cpu"."""

    def __init__(self, base, neighbors, *, dists=None, metric: str = "l2",
                 rng_seed: int = 0, capacity: int | None = None, insert_ef: int = 64,
                 diversify: str = "none", max_keep: int = 0, n_entries: int = 8,
                 metadata: dict | None = None, device="cuda"):
        base = _np(base, np.float32)
        nbrs = _np(neighbors, np.int32)
        if base.ndim != 2 or nbrs.ndim != 2 or base.shape[0] != nbrs.shape[0]:
            raise ValueError(f"base (n, d) and neighbors (n, R) must agree on n, got "
                             f"{base.shape} / {nbrs.shape}")
        n = base.shape[0]
        self._configure(d=base.shape[1], R=nbrs.shape[1], metric=metric, rng_seed=rng_seed,
                        capacity=max(int(capacity) if capacity is not None else n, n, 1),
                        insert_ef=insert_ef, diversify=diversify, max_keep=max_keep,
                        n_entries=n_entries, device=device)
        self._alloc_host(self.capacity)
        # capacity-padded metadata columns for filters: unset rows carry the
        # dtype's fill value AND are tombstoned, so they never answer
        self._meta: dict[str, np.ndarray] = {}
        for name in sorted(metadata or {}):
            col = np.asarray(metadata[name])
            if col.shape != (n,):
                raise ValueError(f"metadata column {name!r} must be ({n},), got {col.shape}")
            full = np.full(self.capacity, _meta_fill(col.dtype), col.dtype)
            full[:n] = col
            self._meta[name] = full
        self._base[:n] = base
        self._nbrs[:n] = nbrs
        self._alive[:n] = True
        self.n_alloc = n
        self._n_live = n
        self._tomb = pack_tombstones(~self._alive)
        self._push_all_device()
        if n:
            d_arr = None if dists is None else _np(dists, np.float32)
            if d_arr is None or np.isnan(d_arr).any():   # diversified graphs
                d_arr = self._edge_dists(self._base_dev[:n], nbrs)
            self._dists[:n] = d_arr
        self._reset_log()
        self.total_inserts = 0
        self.insert_wall_s = 0.0
        self.part_s = dict.fromkeys(INSERT_PARTS, 0.0)
        self.version = 0
        self.last_id_map: np.ndarray | None = None

    def _configure(self, *, d, R, metric, rng_seed, capacity, insert_ef, diversify,
                   max_keep, n_entries, device) -> None:
        if diversify not in INLINE_DIVERSIFIERS:
            raise ValueError(f"unknown inline diversify {diversify!r}; one of "
                             f"{INLINE_DIVERSIFIERS}")
        self.d, self.R = int(d), int(R)
        self.metric = metric
        self.rng_seed = int(rng_seed)
        self.capacity = int(capacity)
        self.insert_ef = int(insert_ef)
        self.diversify = diversify
        self.max_keep = min(int(max_keep) or max(1, self.R // 2), self.R)
        self.n_entries = int(n_entries)
        self.device = resolve_device(device)
        self._nbrs_dirty: set[int] = set()
        self._searcher: Searcher | None = None
        # the mirrors a handed-out Searcher holds; written only after a clone
        self._shared: set[str] = set()
        self.cow_clones = 0
        self.cow_bytes = 0

    def _reset_log(self) -> None:
        self.log: list[tuple[str, int]] = []
        self.inserts_since_compact = 0
        self.deletes_since_compact = 0

    # -- constructors ---------------------------------------------------------

    @classmethod
    def empty(cls, d: int, degree: int, *, capacity: int, **kw) -> "MutableIndex":
        """An index with no points yet: the incremental construct's start."""
        return cls(np.zeros((0, d), np.float32), np.zeros((0, degree), np.int32),
                   capacity=capacity, **kw)

    @classmethod
    def from_build(cls, base, result, **kw) -> "MutableIndex":
        """Wrap a ``GraphBuilder`` output on ``base``'s device (edge
        distances recomputed where the diversify stage left NaN)."""
        kw.setdefault("metric", result.report.spec.metric)
        if isinstance(base, torch.Tensor):
            kw.setdefault("device", base.device)
        return cls(base, result.graph.neighbors, dists=result.graph.dists, **kw)

    @classmethod
    def from_artifact(cls, art, **kw) -> "MutableIndex":
        """Wrap a loaded :class:`~repro_torch.core.io.IndexArtifact` (flat
        graph only): its metric, key (as ``rng_seed``) and metadata."""
        kw.setdefault("metric", art.metric)
        if art.key is not None:
            kw.setdefault("rng_seed", art.rng_seed)
        if art.metadata is not None:
            kw.setdefault("metadata", art.metadata)
        return cls(art.base, art.neighbors, **kw)

    STATE_ARRAYS = ("base", "neighbors", "dists", "alive", "tombstones")
    STATE_COUNTS = ("n_alloc", "capacity", "inserts_since_compact", "deletes_since_compact",
                    "total_inserts", "insert_wall_s", "version")

    def state(self) -> dict:
        """The whole mutable state as numpy (capacity-shaped arrays, uint32
        tombstone words, metadata columns) and Python numbers: what
        :meth:`from_state` and ``core.convert.mutable_from_numpy`` take."""
        st = dict(base=self._base.copy(), neighbors=self._nbrs.copy(),
                  dists=self._dists.copy(), alive=self._alive.copy(),
                  tombstones=self._tomb.copy(),
                  metadata={k: v.copy() for k, v in self._meta.items()})
        st.update({k: getattr(self, k) for k in self.STATE_COUNTS})
        return st

    @classmethod
    def from_state(cls, state: dict, *, metric: str = "l2", rng_seed: int = 0,
                   insert_ef: int = 64, diversify: str = "none", max_keep: int = 0,
                   n_entries: int = 8, device="cuda") -> "MutableIndex":
        """Continue a history from :meth:`state`'s layout: the arrays are
        taken as they are (no edge distance is recomputed) and pushed to
        ``device``."""
        base = _np(state["base"], np.float32)
        nbrs = _np(state["neighbors"], np.int32)
        C = int(state["capacity"])
        if base.shape[0] != C or nbrs.shape[0] != C:
            raise ValueError(f"state arrays must have capacity={C} rows, got "
                             f"{base.shape} / {nbrs.shape}")
        self = cls.__new__(cls)
        self._configure(d=base.shape[1], R=nbrs.shape[1], metric=metric, rng_seed=rng_seed,
                        capacity=C, insert_ef=insert_ef, diversify=diversify,
                        max_keep=max_keep, n_entries=n_entries, device=device)
        self._base = base.copy()
        self._nbrs = nbrs.copy()
        self._dists = _np(state["dists"], np.float32).copy()
        self._alive = _np(state["alive"], bool).copy()
        tomb = _np(state["tombstones"])
        self._tomb = np.array(tomb.view(np.uint32) if tomb.dtype == np.int32 else tomb,
                              np.uint32)
        if not np.array_equal(self._tomb, pack_tombstones(~self._alive)):
            raise ValueError("state tombstones disagree with its alive mask")
        self._meta = {k: np.asarray(v).copy() for k, v in (state.get("metadata") or {}).items()}
        self.n_alloc = int(state["n_alloc"])
        self._n_live = int(self._alive.sum())
        self._push_all_device()
        self.log = []
        self.inserts_since_compact = int(state["inserts_since_compact"])
        self.deletes_since_compact = int(state["deletes_since_compact"])
        self.total_inserts = int(state["total_inserts"])
        self.insert_wall_s = float(state["insert_wall_s"])
        self.part_s = dict.fromkeys(INSERT_PARTS, 0.0)
        self.version = int(state["version"])
        self.last_id_map = None
        return self

    # -- storage --------------------------------------------------------------

    def _alloc_host(self, C: int) -> None:
        self._base = np.zeros((C, self.d), np.float32)
        self._nbrs = np.full((C, self.R), INVALID, np.int32)
        self._dists = np.full((C, self.R), np.inf, np.float32)
        self._alive = np.zeros((C,), bool)

    def _push_all_device(self) -> None:
        dev = self.device
        self._base_dev = _to(self._base, dev)
        self._nbrs_dev = _to(self._nbrs, dev)
        self._alive_dev = _to(self._alive, dev)
        self._tomb_dev = _to(self._tomb.view(np.int32), dev)
        self._shared.clear()

    def _own(self, name: str) -> torch.Tensor:
        """The mirror ``name``, cloned first if a Searcher holds it (copy on
        write: the Searcher keeps the tensor it was given)."""
        t = getattr(self, name)
        if name in self._shared:
            t = t.clone()
            setattr(self, name, t)
            self._shared.discard(name)
            self.cow_clones += 1
            self.cow_bytes += t.numel() * t.element_size()
        return t

    def _flush_nbrs(self) -> None:
        """Write the dirty adjacency rows into the device mirror."""
        if self._nbrs_dirty:
            rows = np.fromiter(self._nbrs_dirty, np.int64, len(self._nbrs_dirty))
            rows.sort()
            self._own("_nbrs_dev").index_copy_(0, _to(rows, self.device),
                                               _to(self._nbrs[rows], self.device))
            self._nbrs_dirty.clear()

    def _write_tomb_words(self, words: np.ndarray) -> None:
        """Copy the host tombstone words ``words`` into the device mirror."""
        self._own("_tomb_dev").index_copy_(0, _to(words.astype(np.int64), self.device),
                                           _to(self._tomb.view(np.int32)[words], self.device))

    def _grow(self) -> None:
        """Double the capacity: new host arrays and mirrors (the search
        shapes change once a doubling), metadata columns included."""
        C, C2 = self.capacity, 2 * self.capacity
        base, nbrs, dists, alive = self._base, self._nbrs, self._dists, self._alive
        self._alloc_host(C2)
        self._base[:C], self._nbrs[:C] = base, nbrs
        self._dists[:C], self._alive[:C] = dists, alive
        for name, col in self._meta.items():
            full = np.full(C2, _meta_fill(col.dtype), col.dtype)
            full[:C] = col
            self._meta[name] = full
        self.capacity = C2
        self._tomb = pack_tombstones(~self._alive)
        self._push_all_device()
        self._nbrs_dirty.clear()
        self._searcher = None

    def _edge_dists(self, base: torch.Tensor, nbrs: np.ndarray) -> np.ndarray:
        """(n, R) distances of each row's edges through ``ops.gather_distance``
        (the pair kernel on the card); +inf where the id is INVALID."""
        from ..kernels import ops

        ids = _to(np.maximum(nbrs, 0), self.device)
        gd = _np(ops.gather_distance(base, ids, base, metric=self.metric))
        return np.where(nbrs >= 0, gd, np.inf).astype(np.float32)

    def _set_tomb(self, i: int, dead: bool) -> None:
        w, b = i >> 5, np.uint32(1 << (i & 31))
        if dead:
            self._tomb[w] |= b
        else:
            self._tomb[w] &= ~b

    def _clock(self, part: str, t0: float) -> float:
        """Charge the time since ``t0`` to ``part`` (the device synchronised
        first, so a part's kernels are billed to it) and return now."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.part_s[part] += t - t0
        return t

    # -- introspection --------------------------------------------------------

    @property
    def n_live(self) -> int:
        return self._n_live

    @property
    def n_dead(self) -> int:
        return self.n_alloc - self._n_live

    @property
    def tombstones(self) -> torch.Tensor:
        """(ceil(capacity/32),) int32 words on the device: deleted AND
        unallocated ids."""
        return self._tomb_dev

    @property
    def alive(self) -> np.ndarray:
        return self._alive[: self.n_alloc].copy()

    @property
    def base(self) -> np.ndarray:
        """(n_alloc, d) rows, deleted slots included (a view)."""
        return self._base[: self.n_alloc]

    @property
    def neighbors(self) -> np.ndarray:
        """(n_alloc, R) adjacency, deleted rows included (a view)."""
        return self._nbrs[: self.n_alloc]

    @property
    def dists(self) -> np.ndarray:
        """(n_alloc, R) edge distances, rows distance-sorted (a view)."""
        return self._dists[: self.n_alloc]

    @property
    def metadata(self) -> dict | None:
        """Metadata columns over allocated rows (None if undeclared)."""
        if not self._meta:
            return None
        return {k: v[: self.n_alloc] for k, v in self._meta.items()}

    @property
    def staleness(self) -> float:
        """(pending inserts + pending deletes) / live points: the share of
        the live set not yet merged through a compaction."""
        return ((self.inserts_since_compact + self.deletes_since_compact)
                / max(self._n_live, 1))

    @property
    def insert_rate(self) -> float:
        """Inserts/s over every insert this index has absorbed."""
        return self.total_inserts / max(self.insert_wall_s, 1e-9)

    def insert_ms(self) -> dict:
        """Milliseconds an insert spends in each of ``INSERT_PARTS``, averaged
        over the inserts this index has absorbed (the device synchronised at
        each part's end)."""
        n = max(self.total_inserts, 1)
        return {p: s * 1e3 / n for p, s in self.part_s.items()}

    def live_graph(self) -> KnnGraph:
        """(n_alloc, R) adjacency and edge distances on the device. Rows of
        deleted vertices are still present: the tombstones mask them."""
        return KnnGraph(_to(self._nbrs[: self.n_alloc], self.device),
                        _to(self._dists[: self.n_alloc], self.device))

    def stats(self) -> dict:
        return {
            "n_live": self._n_live, "n_dead": self.n_dead,
            "n_alloc": self.n_alloc, "capacity": self.capacity,
            "pending_inserts": self.inserts_since_compact,
            "pending_deletes": self.deletes_since_compact,
            "staleness": round(self.staleness, 4),
            "insert_rate": round(self.insert_rate, 1),
            "insert_ms": {p: round(v, 3) for p, v in self.insert_ms().items()},
            "version": self.version,
        }

    # -- mutation -------------------------------------------------------------

    def insert(self, x, entries=None, metadata: dict | None = None) -> int:
        """Insert one point; returns its id. Exact-scan placement while the
        index is tiny (or always, with ``insert_ef=0``); beam search and link
        otherwise, from ``entries`` ((E,) ids) where given, else from the
        index's own draw. ``metadata`` maps a declared column to this row's
        value (omitted columns get the fill value)."""
        x = _np(x, np.float32)
        if x.shape != (self.d,):
            raise ValueError(f"expected a ({self.d},) point, got {x.shape}")
        if metadata:
            unknown = sorted(set(metadata) - set(self._meta))
            if unknown:
                raise ValueError(
                    f"unknown metadata column(s) {unknown}; this index declares "
                    f"{sorted(self._meta)} — declare columns at construction "
                    f"(MutableIndex(metadata=...))")
        t_start = time.perf_counter()
        if self.n_alloc == self.capacity:
            self._grow()
        t0 = self._clock("grow", t_start)
        m = self.n_alloc
        xdev = _to(x, self.device)
        if self.insert_ef <= 0 or self._n_live <= max(self.R, self.insert_ef):
            row_ids, row_d, rec_rows, rec_d = self._exact_place(xdev)
            t0 = self._clock("scan", t0)
        else:
            cand, cd = self._beam_candidates(xdev, entries)
            t0 = self._clock("beam", t0)
            row_ids, row_d, rec_rows, rec_d = self._select(xdev, cand, cd)
            t0 = self._clock("select", t0)
        self.n_alloc = m + 1
        self._base[m] = x
        self._nbrs[m] = row_ids
        self._dists[m] = row_d
        for name, col in self._meta.items():
            val = (metadata or {}).get(name, _meta_fill(col.dtype))
            col[m] = np.asarray(val).astype(col.dtype)
        self._alive[m] = True
        self._n_live += 1
        self._set_tomb(m, False)
        touched = self._link_reciprocal(rec_rows, rec_d, m)
        self._nbrs_dirty.add(m)
        self._nbrs_dirty.update(int(v) for v in touched)
        t0 = self._clock("link", t0)
        # device mirrors: row writes keep the search shapes fixed
        row = torch.tensor([m], device=self.device)
        self._own("_base_dev").index_copy_(0, row, xdev[None, :])
        self._alive_dev.index_fill_(0, row, True)
        self._write_tomb_words(np.array([m >> 5]))
        self._clock("writes", t0)
        self._searcher = None
        self.log.append(("insert", m))
        self.inserts_since_compact += 1
        self.total_inserts += 1
        self.insert_wall_s += time.perf_counter() - t_start
        return m

    def insert_batch(self, points, metadata: dict | None = None, entries=None) -> np.ndarray:
        """Insert rows in order; returns their ids. ``metadata`` (optional)
        maps a column to a (B,) array; ``entries`` (optional, (B, E)) the
        entry ids of each row's beam."""
        pts = _np(points, np.float32)
        return np.array([
            self.insert(p, entries=None if entries is None else entries[i],
                        metadata=None if metadata is None else
                        {k: v[i] for k, v in metadata.items()})
            for i, p in enumerate(pts)
        ], np.int32)

    def delete(self, ids) -> None:
        """Tombstone live vertices, in order: one bitmap bit each, so the
        beam never scores them again. An id that is not live (never
        allocated, already dead, or repeated in ``ids``) raises KeyError
        after the ids before it are deleted. Slots are reclaimed at
        compaction."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        inside = (ids >= 0) & (ids < self.n_alloc)
        ok = inside & self._alive[np.where(inside, ids, 0)]
        _, first = np.unique(ids, return_index=True)
        repeat = np.ones(ids.shape, bool)
        repeat[first] = False
        bad = np.nonzero(~ok | repeat)[0]
        take = ids[: bad[0]] if bad.size else ids
        if take.size:
            self._alive[take] = False
            self._n_live -= int(take.size)
            np.bitwise_or.at(self._tomb, take >> 5,
                             np.left_shift(np.uint32(1), (take & 31).astype(np.uint32)))
            self.log.extend(("delete", int(i)) for i in take)
            self.deletes_since_compact += int(take.size)
            self._alive_dev[_to(take, self.device)] = False
            self._write_tomb_words(np.unique(take >> 5))
            self._searcher = None
        if bad.size:
            raise KeyError(f"id {int(ids[bad[0]])} is not a live vertex")

    def _exact_place(self, xdev: torch.Tensor):
        """Candidates by the masked exact scan: the batch's values in both
        directions, so exact-mode maintenance reproduces ``exact_knn_graph``
        of the live set."""
        fwd, rev = _exact_scan(xdev, self._base_dev, self._alive_dev, self.metric)
        d_sel, order = topk_smallest(fwd, self.R)   # stable: ties -> lowest id
        d_sel, order, rev = _np(d_sel), _np(order), _np(rev)
        keep = np.isfinite(d_sel)
        row_ids = np.where(keep, order, INVALID).astype(np.int32)
        row_d = np.where(keep, d_sel, np.inf).astype(np.float32)
        rows = np.nonzero(self._alive)[0]  # full maintenance: every live row
        return row_ids, row_d, rows, rev[rows]

    def _beam_candidates(self, xdev: torch.Tensor, entries=None):
        """One Q=1 beam of width ``insert_ef`` on the current graph, dead ids
        masked by the tombstones -> (candidate ids, distances), ascending."""
        self._flush_nbrs()
        if entries is None:
            gen = torch.Generator(device=self.device).manual_seed(
                _fold(self.rng_seed, INSERT_FOLD + self.total_inserts))
            ent = random_entries(gen, self.capacity, 1, min(self.n_entries, self.insert_ef))
        else:
            ent = _to(np.asarray(entries, np.int32).reshape(1, -1), self.device)
        res = beam_search(xdev[None, :], self._base_dev, self._nbrs_dev, ent,
                          ef=self.insert_ef, k=self.insert_ef, metric=self.metric,
                          tombstones=self._tomb_dev)
        return _np(res.ids[0]), _np(res.dists[0])

    def _select(self, xdev: torch.Tensor, cand: np.ndarray, cd: np.ndarray):
        """The out-edges of a beam placement through the inline diversify
        stage, and the candidates its reciprocal links go to."""
        valid = cand >= 0
        if self.diversify == "gd":
            keep = _gd_select(self._base_dev, cand, cd, valid, self.metric, self.max_keep)
        elif self.diversify == "dpg":
            keep = _dpg_select(self._base_dev, xdev, cand, valid, self.max_keep)
        else:
            keep = valid & (np.cumsum(valid) <= self.R)
        sel = cand[keep & valid][: self.R]
        seld = cd[keep & valid][: self.R]
        row_ids = np.full(self.R, INVALID, np.int32)
        row_d = np.full(self.R, np.inf, np.float32)
        row_ids[: sel.size] = sel
        row_d[: sel.size] = seld
        return row_ids, row_d, sel.astype(np.int64), seld.astype(np.float64)

    def _link_reciprocal(self, rows, dvals, m: int) -> np.ndarray:
        """Degree-capped reciprocal linking: splice edge (v -> m) into each
        candidate row v where its distance strictly beats v's worst edge
        (incumbents, with lower ids, win ties). Rows stay distance-sorted;
        the evicted edge is the row's worst."""
        if not rows.size:
            return rows
        ok = dvals < self._dists[rows, -1]
        rows, dvals = rows[ok], dvals[ok]
        if not rows.size:
            return rows
        rd = self._dists[rows]
        ri = self._nbrs[rows]
        pos = (rd <= dvals[:, None]).sum(1)  # after equals: ties keep order
        j = np.arange(self.R)[None, :]
        rr = np.arange(rows.size)[:, None]
        src = np.clip(j - 1, 0, self.R - 1)
        left, at = j < pos[:, None], j == pos[:, None]
        self._dists[rows] = np.where(
            left, rd, np.where(at, dvals[:, None], rd[rr, src])).astype(np.float32)
        self._nbrs[rows] = np.where(
            left, ri, np.where(at, m, ri[rr, src])).astype(np.int32)
        return rows

    # -- search ---------------------------------------------------------------

    def searcher(self) -> Searcher:
        """A snapshot Searcher over the current state: the capacity-shaped
        mirrors, the tombstones as every query's initial visited set, hubs
        ranked over live vertices only, and the metadata columns. Later
        mutations leave its answers unchanged (the mirrors it holds are
        copied on their next write). Cached until the next mutation."""
        if self._searcher is None:
            self._flush_nbrs()
            hubs = hub_vertices(self._nbrs, DEFAULT_N_HUBS, alive=self._alive)
            self._searcher = Searcher(self._base_dev, self._nbrs_dev, metric=self.metric,
                                      rng_seed=self.rng_seed, tombstones=self._tomb_dev,
                                      hubs=hubs.to(self.device),
                                      metadata=dict(self._meta) or None)
            self._shared.update(("_base_dev", "_nbrs_dev", "_tomb_dev"))
        return self._searcher

    def search(self, queries, spec, seed: int | None = None, **kw):
        return self.searcher().search(queries, spec, seed, **kw)

    # -- compaction -----------------------------------------------------------

    def compact(self, spec, seed: int | None = None):
        """A batch build of the surviving rows in original id order
        (``build_index(survivors, spec, seed)``, default seed ``rng_seed``),
        then tombstones, log and counters reset. Returns the BuildResult,
        its report stamped with the pre-compact staleness, inserts and
        insert rate; ``last_id_map`` maps old ids to new (INVALID = dead)."""
        from .build import build_index

        pre = (self.staleness, self.inserts_since_compact, self.insert_wall_s)
        surv = np.nonzero(self._alive[: self.n_alloc])[0]
        if surv.size == 0:
            raise ValueError("compact: no live vertices to rebuild from")
        sbase = self._base[surv]
        result = build_index(_to(sbase, self.device), spec,
                             seed=self.rng_seed if seed is None else seed)
        id_map = np.full(self.n_alloc, INVALID, np.int32)
        id_map[surv] = np.arange(surv.size, dtype=np.int32)
        self.last_id_map = id_map

        n, C = surv.size, self.capacity
        nbrs = _np(result.graph.neighbors, np.int32)
        self.R = nbrs.shape[1]
        self._alloc_host(C)
        for name, col in self._meta.items():
            full = np.full(C, _meta_fill(col.dtype), col.dtype)
            full[:n] = col[surv]
            self._meta[name] = full
        self._base[:n] = sbase
        self._nbrs[:n] = nbrs
        self._alive[:n] = True
        self.n_alloc, self._n_live = n, n
        self._tomb = pack_tombstones(~self._alive)
        self._push_all_device()
        d_arr = _np(result.graph.dists, np.float32)
        if np.isnan(d_arr).any():
            d_arr = self._edge_dists(self._base_dev[:n], nbrs)
        self._dists[:n] = d_arr
        self._nbrs_dirty.clear()
        self._searcher = None
        self._reset_log()
        self.version += 1

        result.report.staleness = round(pre[0], 4)
        result.report.inserts = pre[1]
        result.report.insert_rate = (round(pre[1] / pre[2], 1)
                                     if pre[2] > 0 and pre[1] else -1.0)
        return result

    def checkpoint(self, path: str, spec, seed: int | None = None):
        """Compact, then save the rebuilt index as an artifact (``core.io``;
        written to a temporary file and renamed). Returns (written path,
        BuildResult)."""
        result = self.compact(spec, seed=seed)
        art = IndexArtifact.from_build(self._base_dev[: self.n_alloc], result,
                                       metric=self.metric, rng_seed=self.rng_seed,
                                       metadata=self.metadata)
        art.provenance["mutable_version"] = self.version
        return save_index(path, art), result
