"""Levina–Bickel MLE local intrinsic dimension (paper Tab. I, column 6).

lid_mle(x, k): for each sample, with ascending NN distances T_1..T_k,
  m_hat = [ 1/(k-1) * sum_{j<k} ln(T_k / T_j) ]^{-1}
The dataset LID is the average of per-point estimates over a subsample.
The subsample is drawn from a ``torch.Generator`` seeded with ``seed``, so
it differs from the reference's ``jax.random`` draw: the estimate agrees
statistically, not bit for bit.
"""
from __future__ import annotations

import torch

from .bruteforce import exact_search


def lid_mle(x: torch.Tensor, k: int = 20, sample: int = 2000,
            metric: str = "l2", seed: int = 0) -> float:
    n = x.shape[0]
    gen = torch.Generator(device=x.device).manual_seed(seed)
    idx = torch.randperm(n, generator=gen, device=x.device)[: min(sample, n)]
    d, _ = exact_search(x[idx], x, k + 1, metric=metric)
    # drop the self column, convert to reporting scale (sqrt for l2)
    d = d[:, 1:]
    if metric == "l2":
        d = torch.sqrt(torch.clamp(d, min=0.0))
    d = torch.clamp(d, min=1e-12)
    tk = d[:, -1:]
    logs = torch.log(tk / d[:, :-1])
    m_hat = 1.0 / torch.clamp(logs.mean(dim=-1), min=1e-12)
    return float(m_hat.mean())
