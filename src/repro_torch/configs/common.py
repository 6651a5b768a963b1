"""The registry's shared parts, as ``repro/configs/common.py``: ``ArchDef``,
its benchmark cells (``cells``), the shape tables of the recsys and GNN
cells, and the per-cell config rule (:func:`cell_config`). The reference's
lowerables (XLA HLO per mesh cell) have no counterpart here."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    kind: str                 # train | prefill | decode | serve
    skip: str | None = None   # reason, if the cell is skipped by assignment


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str          # lm | recsys | gnn
    model_cfg: object    # the model's config at published widths
    smoke_cfg: object    # the reference's reduced config for CPU tests
    optimizer: str       # adamw | adafactor, the reference's per arch

    def cells(self) -> list[Cell]:
        """The reference's cells of this arch, in its order."""
        if self.family == "lm":
            cfg = self.model_cfg
            subquad = cfg.window is not None or cfg.local_global is not None
            return [
                Cell(self.arch_id, "train_4k", "train"),
                Cell(self.arch_id, "prefill_32k", "prefill"),
                Cell(self.arch_id, "decode_32k", "decode"),
                Cell(self.arch_id, "long_500k", "decode",
                     skip=None if subquad else
                     "pure full-attention arch — long_500k needs sub-quadratic "
                     "attention (DESIGN.md §5)"),
            ]
        if self.family == "gnn":
            return [Cell(self.arch_id, shape, "train") for shape in GNN_SHAPES]
        return [
            Cell(self.arch_id, "train_batch", "train"),
            Cell(self.arch_id, "serve_p99", "serve"),
            Cell(self.arch_id, "serve_bulk", "serve"),
            Cell(self.arch_id, "retrieval_cand", "serve"),
        ]


GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg": dict(n_nodes=232965, n_edges=114_615_892, batch_nodes=1024,
                         fanout=(15, 10), d_feat=602),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=16),
}
RECSYS_SHAPES = {
    "train_batch": dict(batch=65536),
    "serve_p99": dict(batch=512),
    "serve_bulk": dict(batch=262144),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000),
}


def cell_config(ad: ArchDef, shape: str):
    """The model config a cell runs: a GNN cell takes its ``d_feat`` as
    ``d_in`` (and nothing else: the reference's minibatch cell keeps the
    config's fanouts, not the cell's); the other families run the arch's
    config unchanged."""
    if ad.family == "gnn":
        return dataclasses.replace(ad.model_cfg, d_in=GNN_SHAPES[shape]["d_feat"])
    return ad.model_cfg
