"""Faults planted under the timed path, to show that the comparison catches
them: ``with plant(kind, name): ...`` breaks the program while the block
runs. The tests drive whole runs through them; ``control.py --fault`` reads
them at a cell's own size on the card. A cell on one chip has no exchange
between chips, so that fault has no plant here.

Both kinds (``FAULTS[kind]``):

- ``stalled_step``: a step that returns its state unchanged (the beam's
  ``_step``; NN-Descent's ``_round``).
- ``half_batch``: half of the batch left out: the second half of a search
  batch gets the first half's answers; the second half of a built graph's
  rows is left empty.
- ``altered_answer``: an answer altered where it is produced: each search
  answer's nearest id, or every id of a built graph, moved on by one.

Search only:

- ``early_stop``: the beam loop ends after ef / 4 steps, before most rows
  have converged.
- ``visited_unmarked``: the visited bitmap is never written, so the beam
  scores and merges vertices it has already seen.
- ``unrefined_graph``: NN-Descent's rounds do nothing in the index build of
  set-up, so the search runs over GD's pruning of the random initial graph.
"""
from __future__ import annotations

import contextlib

import torch

COMMON = ("stalled_step", "half_batch", "altered_answer")
FAULTS = {"search": COMMON + ("early_stop", "visited_unmarked", "unrefined_graph"),
          "build": COMMON}


def _stalled_round(base, ids, dists, isnew, gen, cfg, metric):
    return ids, dists, torch.zeros_like(isnew), isnew.new_zeros(()).sum()


def _search_faults(name):
    from repro_torch.core import beam_search, nndescent
    from repro_torch.core.engine import Searcher

    if name == "stalled_step":
        return beam_search, "_step", lambda state, *a, **k: state._replace(step=state.step + 1)
    if name == "early_stop":
        step = beam_search._step

        def early(state, *a, **k):
            s = step(state, *a, **k)
            if s.step >= state.cand_ids.shape[1] // 4:      # ef / 4
                s = s._replace(done=torch.ones_like(s.done))
            return s
        return beam_search, "_step", early
    if name == "visited_unmarked":
        return beam_search, "_mark_visited", lambda visited, ids: visited
    if name == "unrefined_graph":
        return nndescent, "_round", _stalled_round
    if name == "half_batch":
        search = Searcher.search

        def half(self, queries, spec, seed=None, **kw):
            h = (queries.shape[0] + 1) // 2
            res = search(self, queries[:h], spec, seed, **kw)

            def twice(t):
                return torch.cat([t, t])[:queries.shape[0]]
            return res._replace(ids=twice(res.ids), dists=twice(res.dists),
                                n_comps=twice(res.n_comps))
        return Searcher, "search", half
    finalize = beam_search._finalize

    def altered(state, queries, base, *a, **k):
        res = finalize(state, queries, base, *a, **k)
        ids = res.ids.clone()
        ids[:, 0] = torch.where(ids[:, 0] >= 0, (ids[:, 0] + 1) % base.shape[0], ids[:, 0])
        return res._replace(ids=ids)
    return beam_search, "_finalize", altered


def _build_faults(name):
    from repro_torch.core import nndescent
    from repro_torch.core.build import GraphBuilder

    if name == "stalled_step":
        return nndescent, "_round", _stalled_round
    build = GraphBuilder.build

    def broken(self, base, seed=0, verbose=False):
        res = build(self, base, seed, verbose)
        nbrs = res.graph.neighbors.clone()
        n = nbrs.shape[0]
        if name == "half_batch":
            nbrs[n // 2:] = -1
        else:
            nbrs = torch.where(nbrs >= 0, (nbrs + 1) % n, nbrs)
        return res._replace(graph=res.graph._replace(neighbors=nbrs))
    return GraphBuilder, "build", broken


@contextlib.contextmanager
def plant(kind: str, name: str):
    """Break the program for the block: ``kind`` "search" or "build" (a
    driver's ``kind``), ``name`` one of ``FAULTS[kind]``."""
    if name not in FAULTS[kind]:
        raise ValueError(f"unknown {kind} fault {name!r}; one of {FAULTS[kind]}")
    owner, attr, fake = (_search_faults if kind == "search" else _build_faults)(name)
    real = getattr(owner, attr)
    setattr(owner, attr, fake)
    try:
        yield
    finally:
        setattr(owner, attr, real)
