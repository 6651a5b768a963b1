"""nd_rounds: NN-Descent rounds a build, the ``repro_torch.nndescent.round``
spans inside the traced builds' ``build`` spans over the builds."""
from annbench.metrics._spans import build_phases


def read(obs):
    found = build_phases(obs, "nndescent.round")
    if not found or not found[1]:
        return None
    return len(found[1]) / found[0]
