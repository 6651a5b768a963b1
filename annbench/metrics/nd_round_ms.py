"""nd_round_ms: milliseconds an NN-Descent round, the mean
``repro_torch.nndescent.round`` span (``core/nndescent.py``, ending with
the round's read of its update count) over the traced builds' rounds."""
from annbench.metrics._spans import build_phases, seconds


def read(obs):
    found = build_phases(obs, "nndescent.round")
    if not found or not found[1]:
        return None
    return 1e3 * seconds(found[1]) / len(found[1])
