"""construct_s: NN-Descent's seconds a build (``BuildReport.wall_construct_s``,
``core/build.py`` -> ``core/nndescent.py``), mean over the window's builds."""


def read(obs):
    walls = obs.get("builds", {}).get("construct_s")
    return sum(walls) / len(walls) if walls else None
