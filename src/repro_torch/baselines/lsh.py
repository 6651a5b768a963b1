"""SRS-style projection LSH [Sun VLDB'14], the paper's LSH baseline, as the
reference's ``src/repro/baselines/lsh.py``.

Project the base onto m gaussian directions (m ~ 6-10), probe the T nearest
candidates in the m-dim space by an exact scan (``ops.distance_matrix``),
rerank them in the original space (``ops.gather_distance``). Only valid for
l2, as the paper notes. The projection draws from a ``torch.Generator``
(or is injected: the tests hand it the reference's).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.topk import topk_smallest


class SRSIndex(NamedTuple):
    proj: torch.Tensor       # (d, m) gaussian projection
    base_proj: torch.Tensor  # (n, m) projected base


def build_srs(base: torch.Tensor, m: int = 8, generator: torch.Generator | None = None,
              proj: torch.Tensor | None = None) -> SRSIndex:
    """The SRS sketch of ``base`` on its device: ``proj`` (d, m) when given,
    else N(0, 1/m) draws from ``generator`` (default: seed 0 on the base's
    device)."""
    d = base.shape[1]
    if proj is None:
        if generator is None:
            generator = torch.Generator(device=base.device).manual_seed(0)
        proj = torch.randn((d, m), generator=generator, device=generator.device) / math.sqrt(m)
    proj = proj.to(device=base.device, dtype=torch.float32).contiguous()
    return SRSIndex(proj=proj, base_proj=(base.float() @ proj).contiguous())


def srs_search(queries: torch.Tensor, base: torch.Tensor, index: SRSIndex, k: int = 1,
               probes: int = 256):
    """(dists (Q, k), ids (Q, k), comps (Q,)): the ``probes`` nearest in the
    projected space, reranked exactly. comps = probes exact comparisons +
    the m-dim scan at m/d of a full comparison per base point."""
    from ..kernels import ops

    Q, d = queries.shape
    n, m = index.base_proj.shape
    queries = queries.float().contiguous()
    qp = (queries @ index.proj).contiguous()                        # (Q, m)
    pd = ops.distance_matrix(qp, index.base_proj)                  # (Q, n) in the tiny space
    _, cand = topk_smallest(pd, probes)
    cand = cand.to(torch.int32).contiguous()
    exact = ops.gather_distance(queries, cand, base)               # (Q, probes)
    dd, jj = topk_smallest(exact, k)
    ids = cand.gather(1, jj)
    comps = torch.full((Q,), int(n * m / d) + probes, dtype=torch.int32,
                       device=queries.device)
    return dd, ids, comps
