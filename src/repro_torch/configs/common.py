"""The registry's shared parts, as ``repro/configs/common.py``: ``ArchDef``,
its benchmark cells (``cells``), the shape tables of every family, the
per-cell config rule (:func:`cell_config`), the sharding rules carried
over rule for rule (``lm_param_specs``, ``fsdp_param_specs``,
``opt_state_specs``, ``recsys_param_specs`` and the batch and cache specs
of each cell), the training step of every recsys and GNN train cell on one
device (:func:`cell_train_step`), and :func:`cell_program`, the
counterpart of the reference's ``build_lowerable``: a cell's step, its
arguments as ``meta`` tensors at the cell's full shapes, their specs and
``donate``, run over a ``DeviceMesh`` as DTensors
(``distributed.sharding``).

The port holds the reference's stacked ``layers.*`` leaves as per-layer
parameters (``layers.{i}.*``, ``models/convert.py``); a rule is applied to
the stacked leaf (the reference's shape) and each layer's parameter takes
its spec with the stacked axis dropped. Adafactor's state is kept per
stacked leaf (``train.optimizer.leaves``), so it takes the reference's
spec as it is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.distributed.tensor.experimental import implicit_replication

from .._device import model_device
from ..distributed import sharding
from ..models import gnn, recsys
from ..models import transformer as T
from ..train.optimizer import leaves, make_optimizer
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
    ``mla_replicated_latents`` are layouts over a mesh (their rules below)
    and change nothing on one device. ``fsdp`` shards the LM's big weights
    over the data axis too; ``parallel_mode`` is ``"tp"`` (tensor parallel
    over ``"model"``), ``"dp"`` (the batch over every axis, parameters
    replicated) or ``"fsdp"`` (the batch over every axis, parameters
    ZeRO-3-sharded over every axis), the reference's."""
    arch_id: str
    family: str          # lm | recsys | gnn
    model_cfg: object    # the model's config at published widths
    smoke_cfg: object    # the reference's reduced config for CPU tests
    optimizer: str       # adamw | adafactor, the reference's per arch
    fsdp: bool = False
    parallel_mode: str = "tp"
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


LM_SHAPES = {
    "train_4k": dict(seq=4096, batch=256),
    "prefill_32k": dict(seq=32768, batch=32),
    "decode_32k": dict(seq=32768, batch=128),
    "long_500k": dict(seq=524288, batch=1),
}
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
            if sharding.is_dtensor(b["nodes"]):   # each rank's own batch nodes
                return sharding.data_parallel_loss(minibatch, m, b)
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
    dev = model_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    loss_fn = cell_loss(ad, shape, gen)
    if model is None and dev.type == "meta":
        build = gnn.SAGE if ad.family == "gnn" else recsys.build
        model = build(cell_config(ad, shape), dev)
    elif model is None:
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


# -- sharding rules (the reference's, rule for rule) --------------------------------
#
# A spec is a tuple with one entry a tensor dim: None, a mesh axis name, or a
# tuple of names. ``mesh`` is anything with ``mesh_dim_names`` and ``shape``
# (a ``DeviceMesh``); the rules read nothing else.


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_ok(mesh, axis, dim_size) -> bool:
    if axis is None:
        return True
    sizes = _sizes(mesh)
    if isinstance(axis, tuple):
        total = 1
        for a in axis:
            if a not in sizes:
                return False
            total *= sizes[a]
        return dim_size % total == 0
    return axis in sizes and dim_size % sizes[axis] == 0


def _spec(mesh, shape, assignment) -> tuple:
    """assignment: an axis name (or None / a tuple) per dim; an axis that
    fails the divisibility check degrades to None."""
    return tuple(axis if _axis_ok(mesh, axis, dim) else None
                 for dim, axis in zip(shape, assignment))


def _none(nd: int) -> tuple:
    return (None,) * nd


def dp_axes(mesh):
    """The batch's axes: ``("pod", "data")`` where both exist, else the one
    name."""
    axes = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    return axes if len(axes) > 1 else axes[0]


def fsdp_param_specs(shapes: dict, mesh) -> dict:
    """ZeRO-3: each leaf's largest dim that every mesh axis divides together
    is sharded over all of them (mesh order); a leaf with none replicated.
    ``shapes``: leaf name -> shape."""
    axes = tuple(mesh.mesh_dim_names)
    total = math.prod(tuple(mesh.shape))

    def rule(dims):
        for i in sorted(range(len(dims)), key=lambda i: -dims[i]):
            if dims[i] % total == 0:
                return tuple(axes if j == i else None for j in range(len(dims)))
        return _none(len(dims))

    return {name: rule(list(sh)) for name, sh in shapes.items()}


def lm_param_specs(shapes: dict, mesh, fsdp: bool, mla_replicated_latents: bool = False) -> dict:
    """Tensor-parallel (+ FSDP over "data") specs of the LM's leaves by
    name, on the reference's leaf shapes (stacked layers on axis 0);
    ``mla_replicated_latents`` replicates MLA's latent down-projections."""
    fs = "data" if fsdp else None

    def rule(path: str, sh) -> tuple:
        name = path.rsplit(".", 1)[-1]
        nd = len(sh)
        lead = [None] * (nd - 2)
        if name in ("embed", "item_emb"):
            return _spec(mesh, sh, ["model", None])
        if name == "lm_head":
            return _spec(mesh, sh, [None, "model"])
        if name == "proj":
            return _spec(mesh, sh, [None, "model"][:nd])
        if name in ("w_dq", "w_dkv", "w_kr") and mla_replicated_latents:
            return _none(nd)
        if name in ("wq", "wk", "wv", "w_uq", "w_uk", "w_uv", "w_dq", "w_dkv", "w_kr"):
            return _spec(mesh, sh, lead + [fs, "model"])
        if name == "wo":
            return _spec(mesh, sh, lead + ["model", fs])
        if name in ("w_gate", "w_up"):
            if nd == 4:
                return _spec(mesh, sh, [None, "model", None, fs])
            if nd == 3 and "mlp" in path and sh[0] != sh[-2]:
                return _spec(mesh, sh, [None, fs, "model"])
            return _spec(mesh, sh, lead + [fs, "model"])
        if name == "w_down":
            if nd == 4:
                return _spec(mesh, sh, [None, "model", fs, None])
            return _spec(mesh, sh, lead + ["model", fs])
        if name == "w1":
            return _spec(mesh, sh, lead + [fs, "model"])
        if name == "w2":
            return _spec(mesh, sh, lead + ["model", fs])
        return _none(nd)   # norms, biases, scalars, the router

    return {name: rule(name, sh) for name, sh in shapes.items()}


def recsys_param_specs(shapes: dict, mesh, tables_2d: bool = False) -> dict:
    """Embedding rows over "model" (over every axis with ``tables_2d``:
    each row has one owner); DeepFM's first-order weights over "model";
    the rest replicated."""
    row_axes = tuple(mesh.mesh_dim_names) if tables_2d else "model"

    def rule(path: str, sh) -> tuple:
        name, nd = path.rsplit(".", 1)[-1], len(sh)
        if "tables" in path and nd == 2:
            return _spec(mesh, sh, [row_axes, None])
        if "first" in path and nd == 1:
            return _spec(mesh, sh, ["model"])
        if name == "item_emb":
            return _spec(mesh, sh, ["model", None])
        return _none(nd)

    return {name: rule(name, sh) for name, sh in shapes.items()}


def reference_leaves(shapes: dict) -> dict:
    """Parameter name -> shape, as the reference's leaves: the stacked
    layers' ``layers.{i}.X`` one leaf ``layers.X`` with the layer count on
    axis 0 (``train.optimizer.leaves``)."""
    out = {}
    for key, names in leaves(shapes).items():
        sh = tuple(shapes[names[0]])
        out[key] = (len(names), *sh) if key != names[0] else sh
    return out


def per_parameter(leaf_specs: dict, shapes: dict) -> dict:
    """Leaf specs -> each parameter's spec: a stacked leaf's with its axis 0
    dropped."""
    out = {}
    for key, names in leaves(shapes).items():
        spec = leaf_specs[key]
        for n in names:
            out[n] = spec[1:] if key != names[0] else spec
    return out


def opt_state_specs(optimizer: str, param_specs: dict, leaf_specs: dict,
                    leaf_shapes: dict) -> dict:
    """The optimizer state's specs: AdamW's m and v shadow the parameters
    (per parameter, as the port keeps them), its step replicated;
    Adafactor's factored statistics (per leaf) drop the axis they reduce:
    vr the last, vc the second to last; a 1-D leaf's vr is its own spec
    and its vc (1,) replicated."""
    if optimizer == "adamw":
        return {"step": (), "m": dict(param_specs), "v": dict(param_specs)}
    if optimizer != "adafactor":
        raise ValueError(f"unknown optimizer {optimizer}")
    vr, vc = {}, {}
    for key, sh in leaf_shapes.items():
        parts = list(leaf_specs[key]) + [None] * (len(sh) - len(leaf_specs[key]))
        if len(sh) >= 2:
            vr[key], vc[key] = tuple(parts[:-1]), tuple(parts[:-2] + parts[-1:])
        else:
            vr[key], vc[key] = tuple(parts), (None,)
    return {"step": (), "vr": vr, "vc": vc}


# -- cell programs (the reference's lowerables, over a DeviceMesh) ------------------


@dataclasses.dataclass
class Program:
    """A cell's step over a mesh: ``step(*args)`` on the arguments laid out
    by ``specs`` (:func:`shard_args`). ``args`` are ``meta`` tensors at the
    cell's full shapes (a model's parameters in its ``nn.Module``), ``specs``
    the matching tree (a model's by parameter name); ``donate`` the
    positions the step updates in place (the reference's donated buffers)."""
    step: Callable
    args: tuple
    specs: tuple
    donate: tuple = ()
    name: str = ""


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _on_mesh(fn):
    """``fn`` with plain tensors it makes (positions, masks, counters)
    taken as replicated next to the DTensors."""
    def run(*args):
        with implicit_replication():
            return fn(*args)
    return run


def shard_args(program: Program, args: tuple, mesh) -> tuple:
    """``args`` (the program's arguments as real or meta tensors: the same
    whole tensors on every rank) laid out over ``mesh`` by
    ``program.specs``: a model's parameters replaced by DTensors in place,
    every other tree of tensors copied into DTensors."""
    out = []
    for a, s in zip(args, program.specs, strict=True):
        if isinstance(a, torch.nn.Module):
            out.append(sharding.shard_module(a, s, mesh))
        else:
            out.append(sharding.shard_tree(a, s, mesh))
    return tuple(out)


def lm_specs(ad: ArchDef, model, mesh) -> tuple[dict, dict, dict]:
    """(parameter specs, leaf specs, leaf shapes) of an LM under
    ``ad.parallel_mode``."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    leaf_shapes = reference_leaves(shapes)
    if ad.parallel_mode == "dp":
        leaf = {k: _none(len(sh)) for k, sh in leaf_shapes.items()}
    elif ad.parallel_mode == "fsdp":
        leaf = fsdp_param_specs(leaf_shapes, mesh)
    else:
        leaf = lm_param_specs(leaf_shapes, mesh, ad.fsdp,
                              ad.extra.get("mla_replicated_latents", False))
    return per_parameter(leaf, shapes), leaf, leaf_shapes


def cache_specs(caches: list, mesh, dp) -> list:
    """Per-layer decode caches: the batch over ``dp``, the slot axis over
    "model" (k / v (B, S, H, dh), MLA's (B, S, r), pos (B, S))."""
    def spec(t):
        return _spec(mesh, t.shape, [dp, "model"] + [None] * (t.dim() - 2))
    return [{k: spec(t) for k, t in c.items()} for c in caches]


def _lm_program(ad: ArchDef, shape: str, mesh) -> Program:
    sh = LM_SHAPES[shape]
    B, S = sh["batch"], sh["seq"]
    dp = dp_axes(mesh)
    if ad.parallel_mode in ("dp", "fsdp"):
        dp = tuple(mesh.mesh_dim_names)
    # the activations and logits pinned as the reference pins them
    tp = None if ad.parallel_mode in ("dp", "fsdp") else "model"
    cfg = dataclasses.replace(
        ad.model_cfg, act_spec=_spec(mesh, (B, S, ad.model_cfg.d_model), [dp, None, None]),
        logit_spec=_spec(mesh, (B, S, ad.model_cfg.vocab), [dp, None, tp]))
    model = T.Transformer(cfg, "meta")
    p_specs, leaf_specs, leaf_shapes = lm_specs(ad, model, mesh)
    name = f"{ad.arch_id}:{shape}"
    if shape == "train_4k":
        opt_init, opt_update = make_optimizer(ad.optimizer)
        train = make_train_step(T.loss_fn, opt_update)

        def step(model, opt_state, batch):
            _, opt_state, metrics = train(model, opt_state, batch)
            return opt_state, metrics["loss"]

        opt_state = opt_init(dict(model.named_parameters()))
        o_specs = opt_state_specs(ad.optimizer, p_specs, leaf_specs, leaf_shapes)
        batch = {"tokens": _meta((B, S), torch.int32), "labels": _meta((B, S), torch.int32)}
        b_specs = {"tokens": (dp, None), "labels": (dp, None)}
        return Program(_on_mesh(step), (model, opt_state, batch), (p_specs, o_specs, b_specs),
                       donate=(0, 1), name=name)
    # prefill and decode_step run under inference_mode, which refuses views of
    # DTensors (decode) or loses their layouts (prefill ran every product
    # whole on every rank); the same functions under no_grad
    if shape == "prefill_32k":
        prefill = torch.no_grad()(T.prefill.__wrapped__)
        return Program(_on_mesh(prefill), (model, _meta((B, S), torch.int32)),
                       (p_specs, (dp, None)), name=name)
    caches = T.init_cache(cfg, B, S, "meta")
    tok_spec = _spec(mesh, (B,), [dp])
    decode = torch.no_grad()(T.decode_step.__wrapped__)
    return Program(_on_mesh(decode),
                   (model, _meta((B,), torch.int32), _meta((B,), torch.int32), caches),
                   (p_specs, tok_spec, tok_spec, cache_specs(caches, mesh, dp)),
                   donate=(3,), name=name)


def _batch_specs(batch: dict, dp) -> dict:
    return {k: (dp,) + _none(v.dim() - 1) for k, v in batch.items()}


def _gnn_batch(shape: str) -> dict:
    sh = GNN_SHAPES[shape]
    if shape == "molecule":
        B, N = sh["batch"], sh["n_nodes"]
        return {"feats": _meta((B, N, sh["d_feat"])), "adj": _meta((B, N, N)),
                "labels": _meta((B,), torch.int32)}
    N, E = sh["n_nodes"], sh["n_edges"]
    if shape == "minibatch_lg":
        B = sh["batch_nodes"]
        return {"feats": _meta((N, sh["d_feat"])), "indptr": _meta((N + 1,), torch.int32),
                "indices": _meta((E,), torch.int32), "nodes": _meta((B,), torch.int32),
                "labels": _meta((B,), torch.int32)}
    return {"feats": _meta((N, sh["d_feat"])), "edges": _meta((E, 2), torch.int32),
            "labels": _meta((N,), torch.int32), "mask": _meta((N,))}


def _gnn_program(ad: ArchDef, shape: str, mesh) -> Program:
    dp = dp_axes(mesh)
    model, opt_state, step = cell_train_step(ad, shape, "meta")
    batch = _gnn_batch(shape)
    if shape == "molecule":
        b_specs = _batch_specs(batch, dp)
    elif shape == "minibatch_lg":
        b_specs = {k: ((dp,) if k in ("nodes", "labels") else _none(v.dim()))
                   for k, v in batch.items()}
    else:
        b_specs = {k: _none(v.dim()) for k, v in batch.items()}
        b_specs["edges"] = _spec(mesh, batch["edges"].shape, [dp, None])
    p_specs = {n: _none(p.dim()) for n, p in model.named_parameters()}
    o_specs = {"step": (), "m": dict(p_specs), "v": dict(p_specs)}
    return Program(_on_mesh(step), (model, opt_state, batch), (p_specs, o_specs, b_specs),
                   donate=(0, 1), name=f"{ad.arch_id}:{shape}")


def _recsys_batch(cfg, B: int) -> dict:
    if isinstance(cfg, recsys.Bert4RecConfig):
        S, M = cfg.seq_len, 40
        return {"items": _meta((B, S), torch.int32), "masked_pos": _meta((B, M), torch.int32),
                "labels": _meta((B, M), torch.int32)}
    batch = {"sparse": _meta((B, len(cfg.vocab_sizes)), torch.int32), "label": _meta((B,))}
    if isinstance(cfg, recsys.DLRMConfig):
        batch = {"dense": _meta((B, cfg.n_dense)), **batch}
    return batch


def _recsys_program(ad: ArchDef, shape: str, mesh) -> Program:
    cfg = ad.model_cfg
    sh = RECSYS_SHAPES[shape]
    dp = dp_axes(mesh)
    B = sh["batch"]
    name = f"{ad.arch_id}:{shape}"
    if shape == "retrieval_cand":
        n, d = sh["n_candidates"], cfg.embed_dim

        def retrieve(items, query):
            return torch.topk(query @ items.T, 100, dim=-1)

        return Program(_on_mesh(retrieve), (_meta((n, d)), _meta((B, d))),
                       (_spec(mesh, (n, d), [tuple(mesh.mesh_dim_names), None]), (None, None)),
                       name=name)
    model = recsys.build(cfg, "meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    p_specs = recsys_param_specs(shapes, mesh, ad.extra.get("tables_2d", False))
    batch = _recsys_batch(cfg, B)
    if shape == "train_batch":
        model, opt_state, step = cell_train_step(ad, shape, "meta", model=model)
        o_specs = {"step": (), "m": {n: p_specs[n] for n in opt_state["m"]},
                   "v": {n: p_specs[n] for n in opt_state["v"]}}
        return Program(_on_mesh(step), (model, opt_state, batch),
                       (p_specs, o_specs, _batch_specs(batch, dp)), donate=(0, 1), name=name)
    if isinstance(cfg, recsys.Bert4RecConfig):
        items = batch["items"]
        return Program(_on_mesh(torch.no_grad()(recsys.next_item_scores)),
                       (model, items), (p_specs, (dp, None)), name=name)

    @torch.no_grad()
    def serve(model, batch):   # the label rides along, as in the reference's batch
        return model(*_recsys_inputs(model, batch))

    return Program(_on_mesh(serve), (model, batch), (p_specs, _batch_specs(batch, dp)),
                   name=name)


def cell_program(ad: ArchDef, shape: str, mesh) -> Program:
    """The counterpart of the reference's ``build_lowerable``: the cell's
    step (train, prefill, decode or serve) with its arguments as ``meta``
    tensors at the cell's full shapes and their specs on ``mesh``. An LM
    train step is ``train_loop.make_train_step`` of ``loss_fn`` with the
    arch's optimizer, prefill ``transformer.prefill``, decode
    ``transformer.decode_step`` over ``init_cache`` (both under ``no_grad``
    in place of their ``inference_mode``). An LM's model (``args[0]``) is
    built from the arch's config with ``act_spec`` and ``logit_spec`` set to
    the cell's activation and logit specs, as the reference pins them; a
    caller that brings its own weights draws them from ``args[0].cfg``. A
    recsys or GNN train
    step is :func:`cell_train_step`'s; a recsys serve step the model's
    forward (BERT4Rec: ``next_item_scores``), ``retrieval_cand`` the
    top-100 of one query's inner products with 1M items. Every step runs
    with plain tensors it makes taken as replicated."""
    if ad.family == "lm":
        return _lm_program(ad, shape, mesh)
    if ad.family == "gnn":
        return _gnn_program(ad, shape, mesh)
    return _recsys_program(ad, shape, mesh)
