"""Device dispatch for the ported kernels.

A CPU tensor goes to the plain version in ``kernels.ref``; a CUDA tensor goes
to the hand-written kernel, which raises on anything it does not take.
Nothing falls back from the card to a plain version. The reference's
one-hot gather branch is not carried over: it exists only for the TPU's
matrix unit and is bit-identical to the plain gather.
"""
from __future__ import annotations

import torch

from . import distance_matrix as _dm
from . import gather_distance as _gd
from . import ref


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}; use 'cuda' or 'cpu'")


def distance_matrix(x, y, metric: str = "l2"):
    """(q, d) x (n, d) -> (q, n), or batched (B, q, d) x (B, n, d)."""
    if _on_cpu(x):
        return ref.distance_matrix_ref(x, y, metric)
    return _dm.distance_matrix(x, y, metric)


def gather_distance(queries, ids, base, metric: str = "l2"):
    """(Q, d) x ids (Q, R) into base (n, d) -> (Q, R); ids < 0 -> +inf."""
    if _on_cpu(queries):
        return ref.gather_distance_ref(queries, ids, base, metric)
    return _gd.gather_distance(queries, ids, base, metric)


def gather_distance_masked(queries, ids, base, visited, metric: str = "l2"):
    """Fused gather + distance + visited/validity mask -> (dists, masked
    ids): padding (< 0) and bitmap-visited ids come back as (+inf, -1)."""
    if _on_cpu(queries):
        return ref.gather_distance_masked_ref(queries, ids, base, visited, metric)
    return _gd.gather_distance_masked(queries, ids, base, visited, metric)


def launch_counts() -> dict[str, int]:
    """Kernel launches per entry point since the last reset."""
    return {**_gd.LAUNCHES, **_dm.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (_gd.LAUNCHES, _dm.LAUNCHES):
        for name in counts:
            counts[name] = 0
