"""The registry's shared parts, as ``repro/configs/common.py``: ``ArchDef``,
its benchmark cells (``cells``), the shape tables of the recsys and GNN
cells, the per-cell config rule (:func:`cell_config`), and the training
step of every recsys and GNN train cell (:func:`cell_train_step`), the
``step`` functions of the reference's lowerables on one device. The
lowerables themselves (XLA HLO per mesh cell, shardings) have no
counterpart here; the LMs train through ``launch/train.py``."""
from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from ..models import gnn, recsys
from ..train.optimizer import make_optimizer
from ..train.train_loop import make_train_step, trainable


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    kind: str                 # train | prefill | decode | serve
    skip: str | None = None   # reason, if the cell is skipped by assignment


@dataclasses.dataclass(frozen=True)
class ArchDef:
    """One arch of the registry. ``extra`` holds the reference's per-arch
    switches: ``sparse_emb_update`` (DLRM's train step updates the tables
    by a scatter-add of the gathered rows' gradients, :func:`cell_train_step`)
    is the only one that changes a one-device step; ``tables_2d`` and
    ``mla_replicated_latents`` are layouts over a mesh and are accepted, as
    the reference's, but change nothing on one device."""
    arch_id: str
    family: str          # lm | recsys | gnn
    model_cfg: object    # the model's config at published widths
    smoke_cfg: object    # the reference's reduced config for CPU tests
    optimizer: str       # adamw | adafactor, the reference's per arch
    extra: dict = dataclasses.field(default_factory=dict)

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


# -- train steps (the reference's lowerable steps on one device) -------------------


SPARSE_EMB_LR = 0.01   # the reference's SGD rate of the sparse table update


def bce_with_logits(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """The mean of ``max(l, 0) - l y + log1p(exp(-|l|))`` over fp32 logits,
    as the reference's recsys train steps write it."""
    logits = logits.float()
    return torch.mean(torch.clamp_min(logits, 0) - logits * label
                      + torch.log1p(torch.exp(-logits.abs())))


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean negative log-likelihood of the fp32 log-softmax."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def _recsys_inputs(model, batch: dict) -> tuple:
    if isinstance(model, recsys.DLRM):
        return batch["dense"], batch["sparse"]
    return (batch["sparse"],)


def cell_loss(ad: ArchDef, shape: str, generator: torch.Generator | None = None):
    """-> loss_fn(model, batch) -> (loss, {}) of a train cell, each as the
    reference's step writes it: BCE on the logits over ``dense`` / ``sparse``
    / ``label`` (DLRM, DeepFM, AutoInt); ``bert4rec_loss`` over ``items``,
    ``masked_pos`` and ``labels``; ``loss_full`` over ``feats``, ``edges``,
    ``labels`` and ``mask`` (full_graph_sm, ogb_products); the NLL of
    ``forward_minibatch`` over ``feats``, ``indptr``, ``indices``, ``nodes``
    and ``labels``, its sampling draws from ``batch["draws"]`` where given,
    else from ``generator`` (minibatch_lg); the NLL of ``forward_dense`` over
    ``feats``, ``adj`` and ``labels`` (molecule)."""
    if ad.family == "recsys":
        if shape != "train_batch":
            raise ValueError(f"{ad.arch_id}: {shape!r} is not a train cell (train_batch)")
        if isinstance(ad.model_cfg, recsys.Bert4RecConfig):
            return lambda m, b: (recsys.bert4rec_loss(m, b["items"], b["masked_pos"],
                                                      b["labels"]), {})
        return lambda m, b: (bce_with_logits(m(*_recsys_inputs(m, b)), b["label"]), {})
    if ad.family != "gnn" or shape not in GNN_SHAPES:
        raise ValueError(f"{ad.arch_id}: no train step for {shape!r} here (the LMs train "
                         "through launch/train.py)")
    if shape == "molecule":
        return lambda m, b: (nll(gnn.forward_dense(m, b["feats"], b["adj"]), b["labels"]), {})
    if shape == "minibatch_lg":
        def minibatch(m, b):
            logits = gnn.forward_minibatch(m, b["feats"], b["indptr"], b["indices"],
                                           b["nodes"], generator=generator,
                                           draws=b.get("draws"))
            return nll(logits, b["labels"]), {}
        return minibatch
    return lambda m, b: (gnn.loss_full(m, b["feats"], b["edges"], b["labels"], b["mask"]), {})


def dense_params(model) -> dict:
    """DLRM's parameters but its tables, turned on for autograd; the tables
    turned off (the sparse step's AdamW sees only these)."""
    for t in model.tables:
        t.requires_grad_(False)
    named = {n: p for n, p in model.named_parameters() if not n.startswith("tables.")}
    for p in named.values():
        p.requires_grad_(True)
    return named


def _sparse_emb_step(opt_update):
    """DLRM's sparse-embedding step: the gathered rows ``tables[i][ids[:,
    i]]`` are leaf tensors that require grad, so no (V, d) gradient of a
    table exists; AdamW (its global-norm clip included) updates the other
    parameters; each table takes ``index_add_(0, ids[:, i], -SPARSE_EMB_LR
    g_i)``, so repeated ids accumulate, as the reference's ``.at[].add``."""
    def step(model, opt_state, batch):
        named = dense_params(model)
        ids = batch["sparse"].long()
        with torch.no_grad():
            rows = [t[ids[:, i]] for i, t in enumerate(model.tables)]
        for r in rows:
            r.requires_grad_(True)
        loss = bce_with_logits(model(batch["dense"], batch["sparse"], rows=rows),
                               batch["label"])
        grads = torch.autograd.grad(loss, list(named.values()) + rows)
        del rows
        _, opt_state, _ = opt_update(dict(zip(named, grads)), opt_state, named)
        with torch.no_grad():
            for i, (t, g) in enumerate(zip(model.tables, grads[len(named):])):
                t.index_add_(0, ids[:, i], g.to(t.dtype), alpha=-SPARSE_EMB_LR)
        return opt_state, loss.detach()

    return step


def cell_train_step(ad: ArchDef, shape: str, device="cuda", *, seed: int = 0, model=None,
                    grad_accum: int = 1):
    """The train step of a recsys or GNN cell on one device -> (model,
    opt_state, step), ``step(model, opt_state, batch) -> (opt_state,
    loss)``: the reference's ``step(params, opt_state, batch) -> (params,
    opt_state, loss)``, the port's optimizer writing the parameters in
    place. The model is ``model`` or one of ``cell_config(ad, shape)`` with
    random weights from ``seed`` on ``device``; the optimizer is the arch's
    at the reference's defaults, its state zeros. The loss is
    :func:`cell_loss`'s (minibatch draws from the batch's ``draws``, else
    from a generator seeded with ``seed`` on the device), through
    ``train_loop.make_train_step`` (``grad_accum`` microbatches a step),
    except DLRM's with ``ad.extra["sparse_emb_update"]``
    (:func:`_sparse_emb_step`; its AdamW state shadows only the non-table
    parameters)."""
    dev = resolve_device(device)
    loss_fn = cell_loss(ad, shape, torch.Generator(device=dev).manual_seed(seed))
    if model is None:
        init = gnn.init_params if ad.family == "gnn" else recsys.init_params
        model = init(cell_config(ad, shape), seed, dev)
    opt_init, opt_update = make_optimizer(ad.optimizer)
    if ad.extra.get("sparse_emb_update", False) and isinstance(model, recsys.DLRM):
        if grad_accum != 1:
            raise ValueError("the sparse-embedding step takes one microbatch")
        return model, opt_init(dense_params(model)), _sparse_emb_step(opt_update)
    train = make_train_step(loss_fn, opt_update, grad_accum)

    def step(model, opt_state, batch):
        _, opt_state, metrics = train(model, opt_state, batch)
        return opt_state, metrics["loss"]

    return model, opt_init(trainable(model)), step
