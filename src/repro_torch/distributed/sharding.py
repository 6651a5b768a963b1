"""DTensor placements for the port's specs, and the ``local_map`` bodies of
the ops DTensor has no rule for.

A spec is the port's ``PartitionSpec``: a tuple with one entry a tensor
dim, each ``None`` (replicated), a mesh axis name, or a tuple of names (the
dim sharded over several axes, major to minor). :func:`placements` turns it
into one ``Placement`` a mesh dim. DTensor takes the shards of one tensor
dim in mesh-dim order; every multi-axis entry of the reference's rules
lists its axes in mesh order (``fsdp_param_specs``, ``dp_axes``,
``tables_2d``, the retrieval items), so the two orders agree, and an entry
that does not is refused rather than laid out in another order.

The model code calls the helpers below only where its operands are
DTensors; a plain tensor takes the plain path unchanged:

* :func:`attention` runs ``ops.flash_attention`` (an autograd Function over
  a hand-written kernel) on each rank's local heads and batch rows: heads
  sharded over a mesh dim that does not shard the batch, where the query
  heads divide it (the kv heads are repeated to the query heads first
  where they do not: ``dh`` is never split), else replicated;
* :func:`gather_last` is ``x.gather(-1, idx[..., None])[..., 0]`` on a
  tensor sharded along its last dim (the vocab-parallel gold logit):
  each rank reads the indices that fall in its shard, a partial sum;
* :func:`moe` runs the GShard dispatch on each rank's batch rows and local
  experts (the combine a partial sum over the expert-sharded dims), with
  the load-balance statistics returned as means over the batch shards;
* :func:`write_rows` writes one slot a row into a cache whose slot axis is
  sharded (decode), each rank writing the slots it holds;
* :func:`gather_rows` is ``table[ids]`` on a table whose rows are sharded
  (the vocab-parallel embedding, the recsys tables): each rank reads the
  ids inside its rows, a partial sum.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor import zeros as dtensor_zeros
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def placements(mesh, spec) -> tuple:
    """spec (one entry a tensor dim) -> one ``Placement`` a mesh dim:
    ``Shard(i)`` on every mesh dim named by entry i, ``Replicate()`` on the
    rest. Raises on an axis the mesh lacks, an axis named twice, or a
    multi-axis entry out of mesh order."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order {names}: DTensor would "
                             "take its shards in another order")
        for j in idx:
            if out[j] != Replicate():
                raise ValueError(f"mesh axis {names[j]!r} shards two dims in {spec}")
            out[j] = Shard(i)
    return tuple(out)


def shard(t: torch.Tensor, mesh, spec) -> DTensor:
    """``t`` (the whole tensor, the same on every rank; or ``meta``) as a
    DTensor laid out by ``spec``."""
    return distribute_tensor(t, mesh, placements(mesh, spec))


def shard_module(module: torch.nn.Module, specs: dict, mesh) -> torch.nn.Module:
    """Replace each parameter of ``module`` (by dotted name) by its DTensor
    under ``specs[name]``, in place, keeping ``requires_grad``."""
    with torch.no_grad():
        for name, p in list(module.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = module.get_submodule(owner) if owner else module
            mod._parameters[leaf] = torch.nn.Parameter(shard(p.data, mesh, specs[name]),
                                                       requires_grad=p.requires_grad)
    return module


def shard_tree(tree, specs, mesh):
    """A tree (dicts, lists) of tensors -> the same tree of DTensors laid
    out by the matching tree of specs (a tensor's spec is a tuple)."""
    if isinstance(tree, torch.Tensor):
        return shard(tree, mesh, specs)
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return type(tree)(shard_tree(v, s, mesh) for v, s in zip(tree, specs, strict=True))


def zeros_tree(tree, specs, mesh):
    """:func:`shard_tree` of zeros shaped and typed as ``tree``'s leaves
    (``meta`` will do), each rank allocating only its shards."""
    if isinstance(tree, torch.Tensor):
        return dtensor_zeros(tree.shape, dtype=tree.dtype, device_mesh=mesh,
                             placements=placements(mesh, specs))
    if isinstance(tree, dict):
        return {k: zeros_tree(v, specs[k], mesh) for k, v in tree.items()}
    return type(tree)(zeros_tree(v, s, mesh) for v, s in zip(tree, specs, strict=True))


def _offset(x: DTensor, pl) -> tuple:
    """This rank's global offset of ``x``'s local shard under ``pl``."""
    return compute_local_shape_and_global_offset(x.shape, x.device_mesh, pl)[1]


def _batch_dims(x: DTensor) -> list[bool]:
    return [p == Shard(0) for p in x.placements]


# -- attention -------------------------------------------------------------------


def attention(fn, q: DTensor, k, v):
    """``fn(q, k, v)`` (the flash-attention call, (B, S, H, d) operands) on
    local shards: the batch as ``q`` holds it, heads over each other mesh
    dim they divide (kv heads repeated to the query heads where they do
    not divide it), else replicated. Returns (B, S, Hq, dhv) in that
    layout."""
    mesh = q.device_mesh
    Hq, Hkv = q.shape[2], k.shape[2]
    batch = _batch_dims(q)
    pl, heads = [], 1
    for i, b in enumerate(batch):
        n = mesh.size(i)
        if b:
            pl.append(Shard(0))
        elif n > 1 and Hq % (heads * n) == 0:
            heads *= n
            pl.append(Shard(2))
        else:
            pl.append(Replicate())
    if Hkv % heads:
        B, S, _, d = k.shape
        k = k[:, :, :, None].expand(B, S, Hkv, Hq // Hkv, d).reshape(B, S, Hq, d)
        B, S, _, d = v.shape
        v = v[:, :, :, None].expand(B, S, Hkv, Hq // Hkv, d).reshape(B, S, Hq, d)
    pl = tuple(pl)
    return local_map(fn, out_placements=(pl,), in_placements=(pl, pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


# -- the vocab-parallel gold logit ------------------------------------------------


def gather_last(x: DTensor, idx) -> DTensor:
    """``x.gather(-1, idx[..., None])[..., 0]`` where ``x``'s last dim may
    be sharded: each rank gathers the indices inside its shard (0
    elsewhere), summed over those mesh dims. An index outside [0, V) reads
    0."""
    mesh, last = x.device_mesh, x.dim() - 1
    x_pl = tuple(p if p in (Shard(0), Shard(last)) else Replicate() for p in x.placements)
    i_pl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in x_pl)
    out_pl = tuple(Partial() if p == Shard(last) else p for p in x_pl)
    off = _offset(x, x_pl)[last]

    def body(xl, il):
        n = xl.shape[-1]
        j = il.long() - off
        inside = (j >= 0) & (j < n)
        got = xl.gather(-1, j.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(inside, got, torch.zeros((), dtype=got.dtype, device=got.device))

    if not is_dtensor(idx):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return local_map(body, out_placements=(out_pl,), in_placements=(x_pl, i_pl),
                     in_grad_placements=(x_pl, i_pl), device_mesh=mesh,
                     redistribute_inputs=True)(x, idx)


# -- MoE ---------------------------------------------------------------------------


def moe(route_fn, experts_fn, combine_fn, p: dict, x: DTensor):
    """The MoE block on local shards -> (out, load, mean prob): each rank
    routes its batch rows over every expert, dispatches to and runs the
    experts it holds (``p["w_gate"]`` sharded on its expert axis over a mesh
    dim that does not shard the batch; every other weight axis gathered),
    and combines their outputs, a partial sum over the expert-sharded mesh
    dims. ``load`` and the mean router probability (E,) are means over the
    batch shards, summed from each shard's mean over the shard count (exact
    for the powers of two of these meshes); the latter is split evenly over
    the expert-sharded dims too, so that its gradient is counted once. ``route_fn(router, x)``,
    ``experts_fn(weights, x, route, e0, e1)`` and ``combine_fn(eout, route,
    e0, e1)`` are the model's own."""
    mesh = x.device_mesh
    batch = _batch_dims(x)
    wpl = p["w_gate"].placements
    ex = [not b and w == Shard(0) for b, w in zip(batch, wpl)]
    x_pl = tuple(Shard(0) if b else Replicate() for b in batch)
    r_pl = tuple(Replicate() for _ in batch)
    e_pl = tuple(Shard(0) if e else Replicate() for e in ex)
    out_pl = tuple(Shard(0) if b else Partial() if e else Replicate()
                   for b, e in zip(batch, ex))
    load_pl = tuple(Partial() if b else Replicate() for b in batch)
    prob_pl = tuple(Partial() if b or e else Replicate() for b, e in zip(batch, ex))
    # means over the batch shards as sums of each shard's mean / shards (a
    # Partial("avg") output would take its full gradient on every rank), the
    # mean probability also split over the expert-sharded dims
    shards = math.prod(mesh.size(i) for i, b in enumerate(batch) if b)
    split = shards * math.prod(mesh.size(i) for i, e in enumerate(ex) if e)
    E = p["w_gate"].shape[0]
    e0 = _offset(p["w_gate"], e_pl)[0]
    e1 = e0 + E // (split // shards)
    grad_x = tuple(Shard(0) if b else Partial() if e else Replicate()
                   for b, e in zip(batch, ex))
    grad_r = tuple(Partial() if b or e else Replicate() for b, e in zip(batch, ex))
    grad_e = tuple(Partial() if b else Shard(0) if e else Replicate()
                   for b, e in zip(batch, ex))

    def body(xl, router, wg, wu, wd):
        route = route_fn(router, xl)
        eout = experts_fn({"w_gate": wg, "w_up": wu, "w_down": wd}, xl, route, e0, e1)
        prob = route.probs.mean((0, 1))
        load = route.load / shards if shards > 1 else route.load
        return combine_fn(eout, route, e0, e1), load, prob / split if split > 1 else prob

    return local_map(body, out_placements=(out_pl, load_pl, prob_pl),
                     in_placements=(x_pl, r_pl, e_pl, e_pl, e_pl),
                     in_grad_placements=(grad_x, grad_r, grad_e, grad_e, grad_e),
                     device_mesh=mesh, redistribute_inputs=True)(
        x, p["router"], p["w_gate"], p["w_up"], p["w_down"])


# -- cache writes ------------------------------------------------------------------


def write_rows(cache: DTensor, slots, values) -> None:
    """``cache[b, slots[b]] = values[b]`` for every row b, in place, where
    ``cache`` (B, S, ...) may be sharded on its batch and slot axes: each
    rank writes the rows it holds at the slots inside its shard."""
    mesh = cache.device_mesh
    c_pl = cache.placements
    b_pl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in c_pl)
    off = _offset(cache, c_pl)[1]

    def body(cl, sl, vl):
        n = cl.shape[1]
        j = sl.long() - off
        inside = (j >= 0) & (j < n)
        rows = torch.arange(cl.shape[0], device=cl.device)
        j = j.clamp(0, n - 1)
        keep = cl[rows, j]
        mask = inside.reshape(-1, *([1] * (vl.dim() - 1)))
        cl.index_put_((rows, j), torch.where(mask, vl.to(cl.dtype), keep))
        return sl

    def as_dt(t):
        return t if is_dtensor(t) else DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                                          run_check=False)

    local_map(body, out_placements=(b_pl,), in_placements=(c_pl, b_pl, b_pl),
              device_mesh=mesh, redistribute_inputs=True)(cache, as_dt(slots), as_dt(values))


# -- row lookups ---------------------------------------------------------------------


def gather_rows(table: DTensor, ids) -> DTensor:
    """``table[ids]`` where ``table``'s rows may be sharded (a vocab-parallel
    embedding): over each mesh dim that shards the rows but not the ids'
    batch, each rank reads the ids inside its rows (0 elsewhere), a partial
    sum; over a mesh dim that shards both, the rows are gathered first. Any
    other table axis is gathered."""
    mesh = table.device_mesh
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    batch = [p == Shard(0) for p in ids.placements]
    rows = [p == Shard(0) and not b for p, b in zip(table.placements, batch)]
    t_pl = tuple(Shard(0) if r else Replicate() for r in rows)
    i_pl = tuple(Shard(0) if b else Replicate() for b in batch)
    out_pl = tuple(Shard(0) if b else Partial() if r else Replicate()
                   for b, r in zip(batch, rows))
    grad_t = tuple(Partial() if b else Shard(0) if r else Replicate()
                   for b, r in zip(batch, rows))
    off = _offset(table, t_pl)[0]

    def body(tl, il):
        n = tl.shape[0]
        j = il.long() - off
        got = tl[j.clamp(0, n - 1)]
        inside = ((j >= 0) & (j < n)).reshape(*j.shape, *([1] * (tl.dim() - 1)))
        return torch.where(inside, got, torch.zeros((), dtype=got.dtype, device=got.device))

    return local_map(body, out_placements=(out_pl,), in_placements=(t_pl, i_pl),
                     in_grad_placements=(grad_t, i_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, ids)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``, through :func:`gather_rows` where ``table`` is a
    DTensor."""
    return gather_rows(table, ids) if is_dtensor(table) else table[ids]


def split_dim(t: torch.Tensor, dim: int, outer: int, inner: int) -> torch.Tensor:
    """Dim ``dim`` of ``t`` (outer * inner) -> (outer, inner). Where ``t`` is
    a DTensor whose ``dim`` is sharded over mesh dims that do not divide
    ``outer``, those dims are gathered first, so a shard never splits
    ``inner`` (a head's width, a kv group)."""
    dim %= t.dim()
    if is_dtensor(t):
        mesh = t.device_mesh
        n = math.prod(mesh.size(i) for i, p in enumerate(t.placements) if p == Shard(dim))
        if outer % n:
            t = t.redistribute(mesh, [Replicate() if p == Shard(dim) else p
                                      for p in t.placements])
    return t.reshape(*t.shape[:dim], outer, inner, *t.shape[dim + 1:])


def split_last(t: torch.Tensor, heads: int, width: int) -> torch.Tensor:
    """(..., heads * width) -> (..., heads, width), as :func:`split_dim`."""
    return split_dim(t, -1, heads, width)


# -- graphs and data-parallel losses -----------------------------------------------


def edge_sums(parts_fn, h, edges: DTensor):
    """``parts_fn(h, edges) -> (per-destination sums, in-degrees)`` over
    edges sharded on their first axis: each rank sums its own edges' rows
    of the gathered ``h``, partial sums over the edge-sharded mesh dims."""
    mesh = edges.device_mesh
    e_pl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in edges.placements)
    r_pl = tuple(Replicate() for _ in e_pl)
    out_pl = tuple(Partial() if p == Shard(0) else Replicate() for p in e_pl)
    return local_map(parts_fn, out_placements=(out_pl, out_pl), in_placements=(r_pl, e_pl),
                     in_grad_placements=(out_pl, e_pl), device_mesh=mesh,
                     redistribute_inputs=True)(h, edges)


class _LossCall(torch.nn.Module):
    def __init__(self, model, loss_fn):
        super().__init__()
        self.model, self.loss_fn = model, loss_fn

    def forward(self, batch):
        return self.loss_fn(self.model, batch)[0]


def data_parallel_loss(loss_fn, model: torch.nn.Module, batch: dict):
    """``loss_fn(model, batch) -> (loss, metrics)`` where the loss is a
    mean over the batch rows: each rank takes its rows of every
    batch-sharded leaf (the rest whole) and the gathered parameters, and
    the loss is the mean of the ranks' losses (equal shards: the global
    mean), the parameters' gradients likewise. Returns (loss, {})."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    keys = list(batch)
    mesh = next(b for b in batch.values() if is_dtensor(b)).device_mesh
    leaves = [b if is_dtensor(b) else DTensor.from_local(b, mesh, [Replicate()] * mesh.ndim,
                                                          run_check=False)
              for b in batch.values()]
    b_pl = [tuple(Shard(0) if p == Shard(0) else Replicate() for p in b.placements)
            for b in leaves]
    batch_dims = [any(pl[i] == Shard(0) for pl in b_pl) for i in range(mesh.ndim)]
    p_pl = tuple(Replicate() for _ in batch_dims)
    avg = tuple(Partial("avg") if b else Replicate() for b in batch_dims)
    call = _LossCall(model, loss_fn)

    def body(*flat):
        local = {"model." + n: t for n, t in zip(names, flat[:len(names)])}
        return torch.func.functional_call(call, local, (dict(zip(keys, flat[len(names):])),))

    loss = local_map(body, out_placements=(avg,), in_placements=(p_pl,) * len(params)
                     + tuple(b_pl), in_grad_placements=(avg,) * len(params) + tuple(b_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*params, *leaves)
    return loss, {}
