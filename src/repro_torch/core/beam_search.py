"""Batched best-first ("hill-climbing" / ef-) search over a flat graph.

The search every graph method in the paper shares (Sec. III): keep a sorted
ef-candidate list; repeatedly expand the best unexpanded vertex; stop when
the best unexpanded candidate is farther than the worst list entry.

Q queries advance in lock-step. Per step each query expands
``expand_width`` vertices, the (Q, W*R) neighbor gather + scoring is one
fused kernel call (``ops.gather_distance_masked`` through the scorer), and
the per-query visited set is a bit-packed (Q, ceil(n/32)) bitmap held as
int32 words (the reference's uint32 bits; torch has no unsigned shift or
scatter-add on the CPU). Finished rows are masked, not exited.

The reference's ``lax.while_loop`` is a host loop here: it reads
``done.all()`` once a step (one device sync a step) and stops when every row
is done or ``max_steps`` is reached. Compressed scorers (``sq8``, ``pq``)
finish with an exact rerank of the best survivors (``_finalize``).

Termination is per query, as the reference's. ``term="fixed"`` keeps the
classic rule; ``term="stable"`` also freezes a row whose top-k has not
improved for ``stable_steps`` steps (a frozen row's slots go INVALID and it
pays no more comparisons). ``restarts > 0`` resurrects converged rows with
fresh seeds (scored through the scorer, charged to ``n_comps``): row r's
draws are a hash of its own key (``restart_keys[r]``) and its restart
count, never of the batch shape, so a padded batch restarts its rows as a
direct search does. The draws differ from the reference's ``jax.random``
ones. ``search_with_trace`` runs a fixed number of steps and records the
best distance and the cumulative comparisons after each (paper Fig. 6).
A filter's ``deny`` bitmap ORs with the tombstones into every row's initial
visited set (``core.filters``). ``beam_traverse`` is the loop without its
rerank, for the host and disk tiers (``core.base_store``): it takes no base.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .scorers import get_scorer
from .topk import INF, INVALID, topk_smallest


class SearchResult(NamedTuple):
    ids: torch.Tensor        # (Q, k) ascending
    dists: torch.Tensor      # (Q, k)
    n_comps: torch.Tensor    # (Q,) distance computations (paper's cost currency)
    n_steps: torch.Tensor    # () loop iterations executed
    # bytes of base representation fetched per query: the scorer's scored
    # bytes (4d exact / d sq8 / M pq per vertex) plus the rerank rows, billed
    # at the tier's grain (4d a row on device and host, whole deduplicated
    # 4 KiB pages on disk)
    bytes_touched: torch.Tensor | int = 0

    @property
    def host_bytes(self):
        """The reference's older name for :attr:`bytes_touched`."""
        return self.bytes_touched


class TraverseResult(NamedTuple):
    """A finished traversal before the rerank: the full candidate list in
    the scorer's currency, for the tiers' rerank (``core.base_store``)."""

    cand_ids: torch.Tensor    # (Q, ef) ascending by scorer distance
    cand_dists: torch.Tensor  # (Q, ef) scorer currency (ADC under pq)
    n_comps: torch.Tensor     # (Q,) raw scored-id count (unscaled)
    n_steps: torch.Tensor     # () loop iterations executed


class _State(NamedTuple):
    cand_ids: torch.Tensor    # (Q, ef) sorted ascending by dist
    cand_dists: torch.Tensor  # (Q, ef)
    expanded: torch.Tensor    # (Q, ef) bool
    visited: torch.Tensor     # (Q, W) int32 bitmap words
    n_comps: torch.Tensor     # (Q,) int32
    done: torch.Tensor        # (Q,) bool
    step: int
    stale: torch.Tensor       # (Q,) int32 steps without a top-k improvement
    restarts_used: torch.Tensor  # (Q,) int32 fresh-seed restarts spent
    seed_best: torch.Tensor   # (Q,) best seed-phase distance (the gate's reference)


TERMINATION_MODES = ("fixed", "stable")


def check_termination(term: str, restarts: int, restart_keys) -> None:
    """Every beam entry point's check of the termination knobs: an unknown
    mode, or restarts without per-row keys, raise ValueError."""
    if term not in TERMINATION_MODES:
        raise ValueError(f"unknown termination mode {term!r}; one of {TERMINATION_MODES}")
    if restarts > 0 and restart_keys is None:
        raise ValueError(
            "restarts > 0 needs restart_keys: (Q,) int64, one key per row "
            "(Searcher.restart_keys draws them per row index, never per batch "
            "shape, so a padded batch restarts as a direct search does)")


def default_max_steps(ef: int, expand_width: int = 1) -> int:
    """Step budget: the beam converges in O(ef) expansions, and expand_width
    W expands W vertices per step."""
    return -(-4 * ef // expand_width) + 64


def mask_padded_queries(entry_ids: torch.Tensor,
                        q_valid: torch.Tensor | None) -> torch.Tensor:
    """Rows with ``q_valid`` False get an all-INVALID entry row: they score
    zero comparisons, freeze on the first step and return (INVALID, +inf,
    0 comps) without perturbing real rows. None means all rows are real."""
    if q_valid is None:
        return entry_ids
    return torch.where(q_valid[:, None], entry_ids,
                       torch.full_like(entry_ids, INVALID))


def dedup_rows(ids: torch.Tensor) -> torch.Tensor:
    """Sort each row and mark repeats INVALID — the dup-free-rows invariant
    ``_mark_visited``'s scatter-add requires. Order is not preserved."""
    srt, _ = torch.sort(ids, dim=1)
    dup = torch.zeros_like(srt, dtype=torch.bool)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    return srt.masked_fill(dup, INVALID)


def _is_visited(visited: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Read bits for ids (Q, R) from the int32 bitmap; ids < 0 read False.
    The shift is arithmetic; bit 0 of the result is still the tested bit."""
    W = visited.shape[1]
    safe = ids.clamp(min=0)
    words = visited.gather(1, torch.clamp(safe >> 5, max=W - 1).long())
    seen = ((words >> (safe & 31)) & 1) > 0
    return seen & (ids >= 0)


def _mark_visited(visited: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Set bits for ids (Q, R); ids < 0 are ignored. Rows must be dup-free
    among unvisited entries (adjacency rows and seeds are deduped), so the
    scatter-add of distinct unset bits is an exact OR. ``1 << 31`` is
    INT32_MIN in int32, which is the right bit pattern."""
    valid = ids >= 0
    word = torch.where(valid, ids >> 5, torch.zeros_like(ids)).long()
    one = torch.ones_like(ids)
    bit = torch.where(valid, one << (ids & 31), torch.zeros_like(ids))
    return visited.scatter_add(1, word, bit)


def _init_state(queries, base, neighbors, entry_ids, ef, metric,
                r_tile: int = 0, scorer: str = "exact", scorer_state=None,
                tombstones=None, deny=None) -> _State:
    Q = queries.shape[0]
    # n from the adjacency: beam_traverse runs with base=None
    n = neighbors.shape[0]
    W = (n + 31) // 32
    E = entry_ids.shape[1]
    dev = queries.device
    # deleted/unallocated ids (tombstones, (W,) int32 words) and a filter's
    # denied ids (deny, (W,) shared or (Q, W) per query) OR into every row's
    # initial visited set, so the mask epilogue drops them everywhere
    init = torch.zeros((1, W), dtype=torch.int32, device=dev)
    if tombstones is not None:
        init = init | tombstones.to(torch.int32).reshape(1, W)
    if deny is not None:
        init = init | deny.to(torch.int32).reshape(-1, W)
    init = init.expand(Q, W).contiguous()
    d0, entry_ids = get_scorer(scorer).score(
        scorer_state, queries, base, entry_ids.contiguous(), init,
        metric=metric, r_tile=r_tile,
    )  # (Q, E)
    visited = _mark_visited(init, entry_ids)

    pad = ef - E
    cand_d = torch.cat([d0, torch.full((Q, pad), INF, device=dev)], dim=1)
    cand_i = torch.cat(
        [entry_ids, torch.full((Q, pad), INVALID, dtype=torch.int32, device=dev)],
        dim=1,
    )
    cand_d, order = torch.sort(cand_d, dim=1, stable=True)
    cand_i = cand_i.gather(1, order)
    return _State(
        cand_ids=cand_i,
        cand_dists=cand_d,
        expanded=torch.zeros((Q, ef), dtype=torch.bool, device=dev),
        visited=visited,
        n_comps=(entry_ids >= 0).sum(dim=1, dtype=torch.int32),
        done=torch.zeros((Q,), dtype=torch.bool, device=dev),
        step=0,
        stale=torch.zeros((Q,), dtype=torch.int32, device=dev),
        restarts_used=torch.zeros((Q,), dtype=torch.int32, device=dev),
        seed_best=cand_d[:, 0],
    )


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of int64 values in [0, 2^32): xor-shifts and
    multiplies by constants below 2^31, so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def restart_draws(keys: torch.Tensor, used: torch.Tensor, E: int, n: int) -> torch.Tensor:
    """(Q,) int64 row keys and (Q,) restarts spent -> (Q, E) int32 ids in
    [0, n): slot j of row r is a hash of (keys[r], used[r], j), a function
    of the row's own key and count only."""
    j = torch.arange(E, dtype=torch.int64, device=keys.device)
    h = _mix32(keys.to(torch.int64)[:, None] & _M32)
    h = _mix32(h ^ _mix32((used.to(torch.int64)[:, None] + 0x3C6EF372) & _M32))
    h = _mix32(h ^ _mix32(j[None, :] + 0x1B873593))
    return (h % n).to(torch.int32)


def _restart_rows(queries, base, metric, r_tile, scorer, scorer_state,
                  restart_keys, restarts: int, restart_gate: float, n: int, E: int,
                  seed_best, cand_i, cand_d, cand_e, visited, n_comps, done, stale,
                  restarts_used):
    """GNNS-style restart, as the reference's ``_restart_rows``: a row that
    converged with budget left (and, where ``restart_gate > 0``, whose best
    distance is still worse than gate x its seed-phase best) draws E fresh
    seeds (:func:`restart_draws`), scores them through the scorer (charged
    to ``n_comps``), marks them visited, merges them unexpanded, and
    resumes. Other rows pass through unchanged: their draws are INVALID,
    scored +inf, and the re-merge of a sorted list is the identity."""
    can = done & (restarts_used < restarts) & (cand_d[:, 0] < INF)
    if restart_gate > 0.0:
        can = can & (cand_d[:, 0] > restart_gate * seed_best)
    draws = restart_draws(restart_keys, restarts_used, E, n)
    draws = dedup_rows(torch.where(can[:, None], draws, torch.full_like(draws, INVALID)))
    rd, rids = get_scorer(scorer).score(scorer_state, queries, base, draws.contiguous(),
                                        visited, metric=metric, r_tile=r_tile)
    n_comps = n_comps + (rids >= 0).sum(dim=1, dtype=torch.int32)
    visited = _mark_visited(visited, rids)
    ef = cand_i.shape[1]
    all_d = torch.cat([cand_d, rd], dim=1)
    all_i = torch.cat([cand_i, rids], dim=1)
    all_e = torch.cat([cand_e, torch.zeros(rids.shape, dtype=torch.bool,
                                           device=rids.device)], dim=1)
    cand_d, order = topk_smallest(all_d, ef)
    return (all_i.gather(1, order), cand_d, all_e.gather(1, order), visited, n_comps,
            done & ~can, torch.where(can, torch.zeros_like(stale), stale),
            restarts_used + can.to(torch.int32))


def _step(state: _State, queries, base, neighbors, metric,
          expand_width: int = 1, r_tile: int = 0, scorer: str = "exact",
          scorer_state=None, k: int = 1, term: str = "fixed",
          stable_steps: int = 8, restarts: int = 0, restart_gate: float = 0.0,
          restart_keys=None) -> _State:
    Q, ef = state.cand_ids.shape
    R = neighbors.shape[1]
    Wd = expand_width

    # 1. best unexpanded candidate(s) per row; ties to the lowest slot
    masked = state.cand_dists.masked_fill(state.expanded, INF)
    best_d, j = topk_smallest(masked, Wd)                          # (Q, W)
    worst = state.cand_dists[:, -1]
    # termination: nothing expandable, or the best unexpanded is worse than
    # the full list's worst (cannot improve the ef set)
    newly_done = (best_d[:, 0] == INF) | (best_d[:, 0] > worst)
    done = state.done | newly_done
    active = ~done

    vtx = state.cand_ids.gather(1, j)                              # (Q, W)
    expandable = (best_d < INF) & active[:, None]
    expanded = state.expanded.scatter(
        1, j, state.expanded.gather(1, j) | expandable)

    # 2. gather neighbors; mask padding/inactive
    nbrs = neighbors[vtx.clamp(min=0).long()].reshape(Q, Wd * R)  # (Q, W*R)
    keep_nbr = (nbrs >= 0) & expandable.repeat_interleave(R, dim=1)
    nbrs = torch.where(keep_nbr, nbrs, torch.full_like(nbrs, INVALID))
    if Wd > 1:  # two expanded vertices may share a neighbor
        nbrs = dedup_rows(nbrs)

    # 3. score + mask + account + mark visited, through the scorer axis;
    # the kernel returns (+inf, INVALID) for padding/visited entries
    nd, nbrs = get_scorer(scorer).score(
        scorer_state, queries, base, nbrs.contiguous(), state.visited,
        metric=metric, r_tile=r_tile,
    )                                                              # (Q, W*R)
    n_comps = state.n_comps + (nbrs >= 0).sum(dim=1, dtype=torch.int32)
    visited = _mark_visited(state.visited, nbrs)

    # 4. merge: the ef best of (ef + W*R), stable, ties to the lowest index
    all_d = torch.cat([state.cand_dists, nd], dim=1)
    all_i = torch.cat([state.cand_ids, nbrs], dim=1)
    all_e = torch.cat(
        [expanded, torch.zeros(nbrs.shape, dtype=torch.bool, device=nbrs.device)],
        dim=1,
    )
    cand_d, order = topk_smallest(all_d, ef)
    cand_i = all_i.gather(1, order)
    cand_e = all_e.gather(1, order)

    # frozen rows keep their state, bit for bit
    frozen = done[:, None]
    cand_i = torch.where(frozen, state.cand_ids, cand_i)
    cand_d = torch.where(frozen, state.cand_dists, cand_d)
    cand_e = torch.where(frozen, state.expanded, cand_e)
    visited = torch.where(frozen, state.visited, visited)
    n_comps = torch.where(done, state.n_comps, n_comps)

    # term="stable": a row whose top-k has not strictly improved for
    # stable_steps steps is done; next step its slots are INVALID
    stale, restarts_used = state.stale, state.restarts_used
    if term == "stable":
        kk = min(k, ef)
        improved = (cand_d[:, :kk] < state.cand_dists[:, :kk]).any(dim=1)
        stale = torch.where(done, state.stale,
                            torch.where(improved, torch.zeros_like(stale), state.stale + 1))
        done = done | (stale >= stable_steps)
    if restarts > 0:
        (cand_i, cand_d, cand_e, visited, n_comps, done, stale,
         restarts_used) = _restart_rows(
            queries, base, metric, r_tile, scorer, scorer_state, restart_keys,
            restarts, restart_gate, neighbors.shape[0], min(ef, 8), state.seed_best,
            cand_i, cand_d, cand_e, visited, n_comps, done, stale, restarts_used)
    return _State(
        cand_ids=cand_i,
        cand_dists=cand_d,
        expanded=cand_e,
        visited=visited,
        n_comps=n_comps,
        done=done,
        step=state.step + 1,
        stale=stale,
        restarts_used=restarts_used,
        seed_best=state.seed_best,
    )


def rerank_slice(ef: int, k: int, rerank: int) -> int:
    """How many survivors the exact rerank touches (0 = the whole ef list)."""
    return ef if rerank <= 0 else max(k, min(rerank, ef))


def _finalize(state: _State, queries, base, k, metric, r_tile, scorer: str,
              scorer_state, rerank: int) -> SearchResult:
    """Loop epilogue. Exact scorer: slice the candidate list. Compressed
    scorers: exact-rerank the top ``rerank`` survivors (0 = all ef) and
    convert the scored-id count into the paper's comparison currency, plus
    one full comparison per reranked candidate."""
    sc = get_scorer(scorer)
    d = base.shape[1]
    n_steps = torch.tensor(state.step, dtype=torch.int32)
    if not sc.needs_rerank:
        return SearchResult(
            ids=state.cand_ids[:, :k],
            dists=state.cand_dists[:, :k],
            n_comps=state.n_comps,
            n_steps=n_steps,
            bytes_touched=sc.scored_bytes(scorer_state, state.n_comps, d),
        )
    from ..kernels import ops

    cand = state.cand_ids[:, :rerank_slice(state.cand_ids.shape[1], k, rerank)]
    cand = cand.contiguous()                    # ascending by scorer distance
    exact = ops.gather_distance(queries, cand, base, metric=metric)  # INVALID -> +inf
    dd, sel = topk_smallest(exact, k)
    n_cand = (cand >= 0).sum(dim=1, dtype=torch.int32)
    return SearchResult(
        ids=cand.gather(1, sel),
        dists=dd,
        n_comps=sc.scale_comps(scorer_state, state.n_comps, d) + n_cand,
        n_steps=n_steps,
        # scored codes during traversal + the float rows the rerank gathered
        bytes_touched=sc.scored_bytes(scorer_state, state.n_comps, d) + n_cand * (4 * d),
    )


def beam_search(
    queries: torch.Tensor,
    base: torch.Tensor,
    neighbors: torch.Tensor,
    entry_ids: torch.Tensor,
    ef: int,
    k: int = 1,
    metric: str = "l2",
    max_steps: int | None = None,
    expand_width: int = 1,
    r_tile: int = 0,
    scorer: str = "exact",
    scorer_state=None,
    rerank: int = 0,
    q_valid: torch.Tensor | None = None,
    term: str = "fixed",
    stable_steps: int = 8,
    restarts: int = 0,
    restart_gate: float = 0.0,
    restart_keys=None,
    tombstones: torch.Tensor | None = None,
    deny: torch.Tensor | None = None,
) -> SearchResult:
    """Best-first graph search. entry_ids (Q, E) int32 seeds (E <= ef).
    expand_width > 1 expands several vertices per step; q_valid (Q,) bool
    marks real rows (see :func:`mask_padded_queries`); tombstones
    (ceil(n/32),) int32 words mark deleted ids. ``r_tile`` is accepted for
    the reference's signature: the CUDA kernel picks its own tile.
    ``term="stable"`` freezes rows whose top-k stalls for ``stable_steps``
    steps; ``restarts``, ``restart_gate`` and ``restart_keys`` ((Q,) int64,
    needed when restarts > 0) resurrect converged rows (module docstring).
    ``deny`` ((W,) or (Q, W) int32 words, a filter's denied ids) ORs with
    the tombstones into the initial visited set. Compressed scorers (``sq8``,
    ``pq``) take their per-batch ``scorer_state`` and rerank the best
    ``rerank`` survivors exactly (0 = the whole ef list); the exact scorer
    ignores ``rerank``."""
    state = _run(queries, base, neighbors, entry_ids, ef, metric, max_steps,
                 expand_width, r_tile, scorer, scorer_state, q_valid, k, term,
                 stable_steps, restarts, restart_gate, restart_keys, tombstones, deny)
    return _finalize(state, queries, base, k, metric, r_tile, scorer,
                     scorer_state, rerank)


def _run(queries, base, neighbors, entry_ids, ef, metric, max_steps, expand_width,
         r_tile, scorer, scorer_state, q_valid, k, term, stable_steps, restarts,
         restart_gate, restart_keys, tombstones, deny) -> _State:
    """The beam loop shared by :func:`beam_search` and :func:`beam_traverse`:
    checks, seeding and steps until every row is done or ``max_steps``."""
    check_termination(term, restarts, restart_keys)
    if expand_width < 1 or entry_ids.shape[1] > ef:
        raise ValueError(f"need expand_width >= 1 and E <= ef, got "
                         f"expand_width={expand_width}, E={entry_ids.shape[1]}, ef={ef}")
    if max_steps is None:
        max_steps = default_max_steps(ef, expand_width)
    entry_ids = mask_padded_queries(entry_ids.to(torch.int32), q_valid)
    state = _init_state(queries, base, neighbors, entry_ids, ef, metric,
                        r_tile, scorer, scorer_state, tombstones, deny)
    while state.step < max_steps and not bool(state.done.all()):
        state = _step(state, queries, base, neighbors, metric, expand_width,
                      r_tile, scorer, scorer_state, k, term, stable_steps,
                      restarts, restart_gate, restart_keys)
    return state


def beam_traverse(
    queries: torch.Tensor,
    neighbors: torch.Tensor,
    entry_ids: torch.Tensor,
    ef: int,
    metric: str = "l2",
    max_steps: int | None = None,
    expand_width: int = 1,
    r_tile: int = 0,
    scorer: str = "pq",
    scorer_state=None,
    q_valid: torch.Tensor | None = None,
    k: int = 1,
    term: str = "fixed",
    stable_steps: int = 8,
    restarts: int = 0,
    restart_gate: float = 0.0,
    restart_keys=None,
    tombstones: torch.Tensor | None = None,
    deny: torch.Tensor | None = None,
) -> TraverseResult:
    """The beam loop without its rerank: the device half of a host- or
    disk-tier search. It takes no base, so the scorer must be base-free
    (``needs_base=False``: ``pq``, ``sq8``); the caller reranks
    ``cand_ids`` against wherever the float rows live. Same loop, operands
    and numerics as :func:`beam_search` (``k`` only sizes the stable-term
    window; the whole ef list comes back)."""
    if getattr(get_scorer(scorer), "needs_base", True):
        raise ValueError(
            f"beam_traverse needs a base-free scorer (got {scorer!r}): the "
            "float base is not an operand here — use beam_search, or a "
            "base-free scorer ('pq', 'sq8')"
        )
    state = _run(queries, None, neighbors, entry_ids, ef, metric, max_steps,
                 expand_width, r_tile, scorer, scorer_state, q_valid, k, term,
                 stable_steps, restarts, restart_gate, restart_keys, tombstones, deny)
    return TraverseResult(cand_ids=state.cand_ids, cand_dists=state.cand_dists,
                          n_comps=state.n_comps,
                          n_steps=torch.tensor(state.step, dtype=torch.int32))


def search_with_trace(
    queries: torch.Tensor,
    base: torch.Tensor,
    neighbors: torch.Tensor,
    entry_ids: torch.Tensor,
    ef: int,
    k: int = 1,
    metric: str = "l2",
    max_steps: int | None = None,
    expand_width: int = 1,
    r_tile: int = 0,
    scorer: str = "exact",
    scorer_state=None,
    rerank: int = 0,
    term: str = "fixed",
    stable_steps: int = 8,
    restarts: int = 0,
    restart_gate: float = 0.0,
    restart_keys=None,
    tombstones: torch.Tensor | None = None,
    deny: torch.Tensor | None = None,
):
    """The beam for exactly ``max_steps`` steps (default
    :func:`default_max_steps`), recording the paper's Fig. 6 statistics:
    returns (result, trace_dist (steps, Q), trace_comps (steps, Q)), the
    best distance and the cumulative comparisons after each step. Rows that
    are done keep their state, so their trace is flat from then on. Under a
    compressed scorer the trace is in the scorer's currency (ADC scores,
    raw scored-id counts); only the result is reranked and rescaled."""
    check_termination(term, restarts, restart_keys)
    if expand_width < 1 or entry_ids.shape[1] > ef:
        raise ValueError(f"need expand_width >= 1 and E <= ef, got "
                         f"expand_width={expand_width}, E={entry_ids.shape[1]}, ef={ef}")
    if max_steps is None:
        max_steps = default_max_steps(ef, expand_width)
    state = _init_state(queries, base, neighbors, entry_ids.to(torch.int32), ef, metric,
                        r_tile, scorer, scorer_state, tombstones, deny)
    td, tc = [], []
    for _ in range(max_steps):
        state = _step(state, queries, base, neighbors, metric, expand_width, r_tile,
                      scorer, scorer_state, k, term, stable_steps, restarts,
                      restart_gate, restart_keys)
        td.append(state.cand_dists[:, 0])
        tc.append(state.n_comps)
    res = _finalize(state, queries, base, k, metric, r_tile, scorer, scorer_state, rerank)
    Q = queries.shape[0]
    dev = queries.device
    if not td:
        return (res, torch.empty((0, Q), device=dev),
                torch.empty((0, Q), dtype=torch.int32, device=dev))
    return res, torch.stack(td), torch.stack(tc)


def projection_entries(queries: torch.Tensor, base_proj: torch.Tensor,
                       proj: torch.Tensor, E: int) -> torch.Tensor:
    """The E nearest base points in a tiny m-dim random projection (m ~ 8,
    SRS-style): an O(n m) scan, m/d of one full pass. base_proj (n, m) is
    the projected base, proj (d, m) the projection; ties go to the lower
    id, as ``lax.top_k`` breaks them."""
    qp = queries @ proj                                           # (Q, m)
    d = ((qp * qp).sum(dim=1)[:, None] - 2.0 * qp @ base_proj.T
         + (base_proj * base_proj).sum(dim=1)[None, :])
    _, ids = topk_smallest(d, E)
    return ids.to(torch.int32)


def random_entries(generator: torch.Generator, n: int, Q: int, E: int) -> torch.Tensor:
    """E random seeds per query (flat-HNSW start, paper Sec. IV), drawn on
    the generator's device: a with-replacement draw plus in-row dedup, with
    collisions left INVALID (the beam needs dup-free rows)."""
    draw = torch.randint(0, n, (Q, E), generator=generator,
                         device=generator.device, dtype=torch.int32)
    return dedup_rows(draw)
