"""diversify_s: GD's seconds a build (``BuildReport.wall_diversify_s``,
``core/diversify.py``), mean over the window's builds."""


def read(obs):
    walls = obs.get("builds", {}).get("diversify_s")
    return sum(walls) / len(walls) if walls else None
