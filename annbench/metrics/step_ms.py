"""step_ms: milliseconds a beam step, the window's search wall (host clock,
each batch ending in ``torch.cuda.synchronize()``) over its total steps."""


def read(obs):
    s = obs.get("search", {})
    steps = sum(s.get("steps", ()))
    return 1e3 * s["wall_s"] / steps if steps else None
