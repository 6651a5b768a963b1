"""Metric layer, as ``repro.core.distances``: every graph and baseline
module is generic over these.

All metrics return "smaller is closer" scores:
  l2  : squared euclidean (monotone in euclidean; sqrt applied only for reporting)
  ip  : negative inner product (for MIPS-style retrieval)
  cos : cosine distance = 1 - cosine similarity

The paper uses l2 for the synthetic/SIFT/GIST data and cosine for GloVe.
These are dense products outside any kernel of the reference, so they run
``torch.matmul`` (fp32: PyTorch leaves TF32 off for matmul by default).
"""
from __future__ import annotations

from typing import Callable

import torch

Metric = str  # 'l2' | 'ip' | 'cos'

METRICS = ("l2", "ip", "cos")


def _sqnorm(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


def pairwise_l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances, (n, d) x (m, d) -> (n, m), clamped at 0."""
    xx = _sqnorm(x)[:, None]
    yy = _sqnorm(y)[None, :]
    return torch.clamp(xx - 2.0 * (x @ y.T) + yy, min=0.0)


def pairwise_ip(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Negative inner product, (n, d) x (m, d) -> (n, m)."""
    return -(x @ y.T)


def pairwise_cos(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cosine distance (1 - cos sim), (n, d) x (m, d) -> (n, m); a zero row
    has norm 1e-6 under the clamp, so its distances are 1."""
    xn = x * torch.rsqrt(torch.clamp(_sqnorm(x), min=1e-12))[:, None]
    yn = y * torch.rsqrt(torch.clamp(_sqnorm(y), min=1e-12))[:, None]
    return 1.0 - xn @ yn.T


_PAIRWISE: dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "l2": pairwise_l2,
    "ip": pairwise_ip,
    "cos": pairwise_cos,
}


def pairwise(x: torch.Tensor, y: torch.Tensor, metric: Metric = "l2") -> torch.Tensor:
    """Dense (n, m) distance matrix under ``metric``."""
    return _PAIRWISE[metric](x, y)


def point_to_points(q: torch.Tensor, pts: torch.Tensor, metric: Metric = "l2") -> torch.Tensor:
    """(d,) vs (m, d) -> (m,) distances."""
    return pairwise(q[None, :], pts, metric)[0]


def distance(a: torch.Tensor, b: torch.Tensor, metric: Metric = "l2") -> torch.Tensor:
    """Scalar distance between two vectors."""
    return point_to_points(a, b[None, :], metric)[0]


def report_scale(d, metric: Metric):
    """Convert internal scores to the paper's reporting scale (euclidean
    for l2)."""
    if metric == "l2":
        return torch.sqrt(torch.clamp(d, min=0.0))
    return d
