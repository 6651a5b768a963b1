"""Index containers and adjacency statistics.

All adjacency is fixed-out-degree, padded with INVALID (-1). Ids are global
row indices into the base matrix. The statistics are host-side numpy, as in
the reference: they run once per build.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .topk import INVALID


class KnnGraph(NamedTuple):
    """Flat k-NN (or diversified) graph.

    neighbors : (n, R) int32, padded with -1
    dists     : (n, R) f32, +inf at padding (metric scores to the host vertex)
    """

    neighbors: torch.Tensor
    dists: torch.Tensor

    @property
    def n(self) -> int:
        return self.neighbors.shape[0]

    @property
    def degree(self) -> int:
        return self.neighbors.shape[1]


class HnswIndex(NamedTuple):
    """Layered small-world index (paper Fig. 1 structure), as the
    reference's.

    layers_neighbors : tuple over layers 0..L-1 of (n_l, M_l) int32 adjacency
                       in global id space (-1 padded); layer 0 is the bottom
                       (all nodes, M_0 = 2M as in hnswlib).
    layers_nodes     : tuple of (n_l,) int32, the global ids on each layer.
    layers_slot      : tuple of (n,) int32, global id -> row in that layer's
                       adjacency (-1 if absent).
    entry_point      : () int32 global id on the top layer.
    levels           : (n,) int32 top level of each node.
    """

    layers_neighbors: tuple
    layers_nodes: tuple
    layers_slot: tuple
    entry_point: torch.Tensor
    levels: torch.Tensor

    @property
    def num_layers(self) -> int:
        return len(self.layers_neighbors)

    def bottom_graph(self) -> KnnGraph:
        """The flat graph = the bottom layer (the paper's flat-HNSW)."""
        nbrs = self.layers_neighbors[0]
        return KnnGraph(neighbors=nbrs,
                        dists=torch.full(nbrs.shape, float("inf"), device=nbrs.device))


def memory_bytes(tensors) -> int:
    """Index memory footprint: bytes of a tensor or of every tensor in a
    (nested) tuple/list such as a :class:`KnnGraph` or an
    :class:`HnswIndex`."""
    if isinstance(tensors, torch.Tensor):
        return tensors.numel() * tensors.element_size()
    return sum(memory_bytes(t) for t in tensors)


def degree_distribution(neighbors) -> dict:
    """Realized out-degree distribution of a padded adjacency: a JSON-able
    summary (min/mean/max + histogram over 0..R)."""
    deg = np.asarray(_np(neighbors) >= 0).sum(axis=1)
    R = neighbors.shape[1]
    return {
        "min": int(deg.min()),
        "mean": round(float(deg.mean()), 2),
        "max": int(deg.max()),
        "hist": np.bincount(deg, minlength=R + 1).tolist(),
    }


DEFAULT_N_HUBS = 64


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def in_degree(neighbors, alive=None) -> np.ndarray:
    """Realized in-degree per vertex of a padded adjacency (numpy int64).
    ``alive`` (n,) bool masks tombstoned vertices out on both ends of an
    edge."""
    nb = _np(neighbors)
    n = nb.shape[0]
    valid = nb >= 0
    if alive is not None:
        alive = _np(alive).astype(bool)
        valid = valid & alive[:, None] & alive[np.maximum(nb, 0)]
    return np.bincount(nb[valid].ravel(), minlength=n)


def in_degree_distribution(neighbors, alive=None) -> dict:
    """JSON-able in-degree summary: spread percentiles plus the edge mass
    landing on the top ``DEFAULT_N_HUBS`` vertices."""
    deg = in_degree(neighbors, alive)
    if alive is not None:
        deg = deg[_np(alive).astype(bool)]
    if deg.size == 0:
        return {"min": 0, "mean": 0.0, "p50": 0, "p90": 0, "p99": 0,
                "max": 0, "hub_mass": 0.0}
    total = max(int(deg.sum()), 1)
    top = np.sort(deg)[::-1][:DEFAULT_N_HUBS]
    return {
        "min": int(deg.min()),
        "mean": round(float(deg.mean()), 2),
        "p50": int(np.percentile(deg, 50)),
        "p90": int(np.percentile(deg, 90)),
        "p99": int(np.percentile(deg, 99)),
        "max": int(deg.max()),
        "hub_mass": round(float(top.sum()) / total, 4),
    }


def hub_vertices(neighbors, count: int = DEFAULT_N_HUBS,
                 alive=None) -> torch.Tensor:
    """The ``count`` highest in-degree vertices, in-degree descending with
    ties broken by lowest id. Returned as int32 on the adjacency's device
    (CPU for a numpy adjacency)."""
    deg = in_degree(neighbors, alive)
    if alive is not None:
        deg = np.where(_np(alive).astype(bool), deg, -1)
    order = np.argsort(-deg, kind="stable")
    if alive is not None:
        order = order[deg[order] >= 0]
    hubs = torch.from_numpy(order[: min(count, order.shape[0])].astype(np.int32))
    if isinstance(neighbors, torch.Tensor):
        hubs = hubs.to(neighbors.device)
    return hubs


def pad_neighbors(neighbors: torch.Tensor, degree: int) -> torch.Tensor:
    """Pad/truncate (n, r) adjacency to (n, degree) with INVALID."""
    n, r = neighbors.shape
    if r >= degree:
        return neighbors[:, :degree]
    pad = torch.full((n, degree - r), INVALID, dtype=neighbors.dtype,
                     device=neighbors.device)
    return torch.cat([neighbors, pad], dim=1)
