"""GraphSAGE [Hamilton '17] on the port, as ``repro/models/gnn.py``.

Message passing is a gather of source rows and a reduction into their
destinations over an edge list (E, 2): ``index_add_`` for sum and mean (the
reference's ``segment_sum``; in chunks of edges, forward and backward, so
no (E, d) message tensor is held), ``scatter_reduce_(amax)`` for max. No Pallas
kernel computes it in the reference, so it stays plain PyTorch here. On
CUDA ``index_add_`` sums each destination's messages in no fixed order (float
atomics), so two card calls of the full-graph forward may differ in the last
bits; ``chip_smoke.py`` phase 14 says whether they did and holds them within
its stated tolerance. Three regimes:

  * full graph: :func:`forward_full`, each layer aggregating every edge;
  * minibatch: :func:`sample_blocks` (a layer-wise uniform
    with-replacement sampler over CSR at fixed fanouts), :func:`gather_blocks`
    (the feature rows of each depth) and :func:`collapse` (the layers,
    bottom up); :func:`forward_minibatch` runs the three;
  * batched small graphs: :func:`forward_dense` over a dense (B, N, N)
    adjacency (the molecule cells).

The sampler's draws come from a ``torch.Generator``; every sampling entry
point also takes the draws themselves, so the tests can feed the
reference's. :func:`edges_from_knn` builds a graph's edges from points with
the port's NN-Descent (the paper's technique as a GNN input).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from .._device import model_device
from ..distributed import sharding
from .recsys import _Model, _param, draw_weights

INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str = "graphsage"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 128
    n_classes: int = 41
    fanouts: tuple[int, ...] = (25, 10)   # sampling fanout per layer
    aggregator: str = "mean"
    dtype: Any = torch.float32


class SAGELayer(nn.Module):
    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        self.w_self = _param((d_in, d_out), dtype, device)
        self.w_nbr = _param((d_in, d_out), dtype, device)


class SAGE(_Model):
    """``layers.{i}`` (w_self, w_nbr) and the class ``head``, the
    reference's tree; weights uninitialised (:func:`init_params` or
    ``convert.sage_params_from_numpy`` fill them)."""

    def __init__(self, cfg: SAGEConfig, device="cuda"):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        dims = [cfg.d_in] + [cfg.d_hidden] * cfg.n_layers
        self.layers = nn.ModuleList(SAGELayer(dims[i], dims[i + 1], cfg.dtype, device)
                                    for i in range(cfg.n_layers))
        self.head = _param((cfg.d_hidden, cfg.n_classes), cfg.dtype, device)


@torch.no_grad()
def init_params(cfg: SAGEConfig, seed: int = 0, device="cuda") -> SAGE:
    """A ``SAGE`` with random weights drawn on ``device`` from a generator
    seeded with ``seed``: each matrix normal times ``fan_in ** -0.5``, as
    the reference's init (its law, not its draws)."""
    return draw_weights(SAGE(cfg, device), seed)


def _normalize(h: torch.Tensor) -> torch.Tensor:
    return h * torch.rsqrt(torch.sum(h * h, dim=-1, keepdim=True).clamp_min(1e-12))


def _layer(lp: SAGELayer, h: torch.Tensor, agg: torch.Tensor, last: bool) -> torch.Tensor:
    h = h @ lp.w_self + agg @ lp.w_nbr
    return _normalize(h if last else torch.relu(h))


# -- full graph ------------------------------------------------------------------


EDGE_CHUNK = 1 << 22   # edges a message chunk of the sum aggregate holds


def _edge_sum(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """(n, d): each destination's sum of its sources' rows, EDGE_CHUNK edges
    at a time in edge order."""
    out = h.new_zeros((n, h.shape[1]))
    for lo in range(0, src.numel(), EDGE_CHUNK):
        out.index_add_(0, dst[lo:lo + EDGE_CHUNK], h[src[lo:lo + EDGE_CHUNK]])
    return out


class _EdgeSum(torch.autograd.Function):
    """:func:`_edge_sum` whose gradient is the same sum along the reversed
    edges, so neither pass holds the (E, d) messages (autograd would keep
    them: ``index_add_`` saves its source)."""

    @staticmethod
    def forward(ctx, h, src, dst, n):
        ctx.save_for_backward(src, dst)
        ctx.rows = h.shape[0]
        return _edge_sum(h, src, dst, n)

    @staticmethod
    def backward(ctx, grad):
        src, dst = ctx.saved_tensors
        return _edge_sum(grad, dst, src, ctx.rows), None, None, None


def aggregate(h: torch.Tensor, edges: torch.Tensor, n: int, aggregator: str) -> torch.Tensor:
    """edges (E, 2) src -> dst; each destination's mean, sum or max of its
    sources' rows of h (0 where a node has no in-edge). The sum is taken
    over chunks of EDGE_CHUNK edges in edge order (on the CPU the order of
    one ``index_add_``, the reference's ``segment_sum`` order), its
    gradient likewise: ogb_products' layer-2 messages are 31 GB at d=128."""
    if sharding.is_dtensor(edges):
        if aggregator == "max":
            raise NotImplementedError("the max aggregate over sharded edges is not ported")
        total, deg = sharding.edge_sums(
            lambda hl, el: _edge_parts(hl, el, n, aggregator), h, edges)
    else:
        total, deg = _edge_parts(h, edges, n, aggregator)
    if aggregator == "max":
        return torch.where(torch.isfinite(total), total, 0.0)
    if aggregator == "sum":
        return total
    return total / deg.clamp_min(1.0)[:, None]


def _edge_parts(h: torch.Tensor, edges: torch.Tensor, n: int, aggregator: str):
    """(each destination's sum of its messages (max, -inf where none, for
    "max"), its in-degree in h's dtype (zeros unless "mean"))."""
    src, dst = edges[:, 0].long(), edges[:, 1].long()
    if aggregator == "max":
        msgs = h[src]
        out = torch.full((n, h.shape[1]), -math.inf, dtype=h.dtype, device=h.device)
        out.scatter_reduce_(0, dst[:, None].expand_as(msgs), msgs, reduce="amax")
        return out, h.new_zeros((n,))
    summed = _EdgeSum.apply(h, src, dst, n)
    if aggregator == "sum":
        return summed, h.new_zeros((n,))
    deg = torch.zeros((n,), dtype=torch.long, device=dst.device)   # bincount has no meta form
    return summed, deg.scatter_add_(0, dst, torch.ones_like(dst)).to(h.dtype)


def forward_full(model: SAGE, feats: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """feats (N, d_in), edges (E, 2) -> logits (N, n_classes); every layer's
    rows scaled to unit norm (rsqrt of the squared norm, floored at 1e-12)."""
    cfg = model.cfg
    h = feats.to(cfg.dtype)
    n = feats.shape[0]
    for i, lp in enumerate(model.layers):
        h = _layer(lp, h, aggregate(h, edges, n, cfg.aggregator), i == cfg.n_layers - 1)
    return h @ model.head


def loss_full(model: SAGE, feats, edges, labels, mask) -> torch.Tensor:
    """The masked mean of the fp32 log-softmax's negative log-likelihood."""
    logp = torch.log_softmax(forward_full(model, feats, edges).float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


# -- neighbor sampling (minibatch) -------------------------------------------------


def neighbor_draws(generator: torch.Generator | None, n_nodes: int, fanout: int,
                   device=None) -> torch.Tensor:
    """(n_nodes, fanout) uniform int32 draws in [0, 2**31 - 1), as the
    reference's ``randint(key, ..., 0, iinfo(int32).max)``, from
    ``generator`` (on its device), or unseeded on ``device`` where there is
    none (``meta``: the dry run's shapes)."""
    dev = generator.device if generator is not None else device
    return torch.randint(0, INT32_MAX, (n_nodes, fanout), generator=generator,
                         device=dev, dtype=torch.int32)


def sample_neighbors(draws: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor,
                     nodes: torch.Tensor) -> torch.Tensor:
    """nodes (B,) and draws (B, fanout) -> (B, fanout) neighbor ids from the
    CSR (indptr, indices): the ``draw % degree``-th neighbor (uniform, with
    replacement); an isolated node samples itself."""
    nodes = nodes.long()
    start = indptr[nodes].long()
    deg = indptr[nodes + 1].long() - start
    off = draws.long() % deg.clamp_min(1)[:, None]
    # an isolated last node points one past the end: clamp (its row is
    # replaced by the node itself), as the reference's gather clamps
    nbr = indices[(start[:, None] + off).clamp_max(indices.numel() - 1)]
    return torch.where(deg[:, None] > 0, nbr, nodes[:, None].to(nbr.dtype))


def sample_blocks(indptr: torch.Tensor, indices: torch.Tensor, batch_nodes: torch.Tensor,
                  fanouts, generator: torch.Generator | None = None,
                  draws: list | None = None) -> list[torch.Tensor]:
    """The block tree: frontier 0 is the batch (B,), frontier l + 1 the
    (B, f1, ..., f_{l+1}) neighbors sampled for frontier l with
    ``fanouts[l]``. Layer l's draws are ``draws[l]`` ((frontier l's size,
    fanouts[l])) where given, else drawn from ``generator`` in layer
    order."""
    frontiers = [batch_nodes]
    for l, fan in enumerate(fanouts):
        flat = frontiers[-1].reshape(-1)
        r = (draws[l] if draws is not None
             else neighbor_draws(generator, flat.shape[0], fan, flat.device))
        nbr = sample_neighbors(r, indptr, indices, flat)
        frontiers.append(nbr.reshape(frontiers[-1].shape + (fan,)))
    return frontiers


def gather_blocks(feats: torch.Tensor, frontiers: list, dtype) -> list[torch.Tensor]:
    """Each frontier's feature rows, (..., d_in) in ``dtype``."""
    return [feats[f.long()].to(dtype) for f in frontiers]


def collapse(model: SAGE, hs: list) -> torch.Tensor:
    """The layers bottom up over the gathered block tree: after layer i,
    depths 0..L-1-i hold updated rows (the tree shrinks a level a layer),
    each depth aggregating its children by mean (or max for any other
    aggregator, as the reference's minibatch path) -> (B, n_classes)."""
    cfg = model.cfg
    for li, lp in enumerate(model.layers):
        hs = [_layer(lp, hs[l],
                     hs[l + 1].mean(dim=-2) if cfg.aggregator == "mean"
                     else hs[l + 1].amax(dim=-2), li == cfg.n_layers - 1)
              for l in range(len(hs) - 1)]
    return hs[0] @ model.head


def forward_minibatch(model: SAGE, feats: torch.Tensor, indptr: torch.Tensor,
                      indices: torch.Tensor, batch_nodes: torch.Tensor,
                      generator: torch.Generator | None = None,
                      draws: list | None = None) -> torch.Tensor:
    """Layer-wise sampled forward at ``cfg.fanouts[:n_layers]``: sample the
    block tree, gather its rows, collapse it (GraphSAGE minibatch)."""
    cfg = model.cfg
    frontiers = sample_blocks(indptr, indices, batch_nodes, cfg.fanouts[:cfg.n_layers],
                              generator, draws)
    return collapse(model, gather_blocks(feats, frontiers, cfg.dtype))


def forward_dense(model: SAGE, feats: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """Batched small graphs: feats (B, N, d), adj (B, N, N) 0/1 -> the mean
    pool of the last layer's rows through the head (B, n_classes)."""
    cfg = model.cfg
    h = feats.to(cfg.dtype)
    deg = adj.sum(dim=-1, keepdim=True).clamp_min(1.0)
    for i, lp in enumerate(model.layers):
        h = _layer(lp, h, (adj @ h) / deg, i == cfg.n_layers - 1)
    return h.mean(dim=1) @ model.head


def knn_config(k: int = 8):
    """The NN-Descent config of :func:`edges_from_knn`: k neighbors, 8
    rounds, and a local join that samples min(12, k) of a vertex's
    neighbors (the reference's config samples 12 and fails for k < 12, its
    default 8)."""
    from ..core.nndescent import NNDescentConfig

    cfg = NNDescentConfig(k=k, rounds=8)
    return cfg._replace(sample=min(cfg.sample, k))


def edges_from_knn(points: torch.Tensor, k: int = 8, metric: str = "l2") -> torch.Tensor:
    """The paper's technique as a GNN input: the (n k, 2) int32 edges
    v -> each of v's k NN-Descent neighbors (:func:`knn_config`, on the
    points' device); a missing neighbor gives the edge (0, 0), as the
    reference's."""
    from ..core.nndescent import build_knn_graph

    g = build_knn_graph(points, knn_config(k), metric=metric)
    n = points.shape[0]
    src = torch.arange(n, dtype=torch.int32, device=points.device).repeat_interleave(k)
    dst = g.neighbors.reshape(-1)
    keep = dst >= 0
    return torch.stack([torch.where(keep, src, 0), torch.where(keep, dst, 0)], dim=1)
