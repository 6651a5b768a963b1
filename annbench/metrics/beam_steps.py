"""beam_steps: mean beam-loop steps a batch over the window's batches
(``SearchResult.n_steps``, the beam loop in ``core/beam_search.py``)."""


def read(obs):
    steps = obs.get("search", {}).get("steps")
    return sum(steps) / len(steps) if steps else None
