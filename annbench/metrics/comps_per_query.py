"""comps_per_query: distance computations a query (``SearchResult.n_comps``,
the exact scorer's charge), over every query of the window."""


def read(obs):
    s = obs.get("search", {})
    return s["comps"] / s["rows"] if s.get("rows") else None
