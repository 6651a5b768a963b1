"""Carry the reference's parameters into the port's models: the LMs
(``lm_params_from_numpy``), the recsys models (``recsys_params_from_numpy``)
and GraphSAGE (``sage_params_from_numpy``), each a tree of numpy leaves
matched to the model's parameters by dotted name.

``lm_params_from_numpy`` takes the tree of ``repro.models.transformer.
init_params`` with its leaves as numpy arrays (``np.asarray`` of each), so
the tests can run both packages on the same weights. The reference stacks
the weights of the ``n_scan_layers`` layers after the dense prefix on axis 0
(``params["layers"]``, an MoE layer's experts as (L, E, D, F)); they are
unstacked into the per-layer modules. The dense prefix is a list of layer
trees (``params["prefix"]``, flattened as ``prefix.{i}.…``) and the MTP head
a tree of its own (``mtp.proj``, ``mtp.layer.…``, ``mtp.norm``). dtypes are
kept and checked per parameter: bf16 arrives as numpy's ``bfloat16``
extension type (2-byte items) and goes across bit for bit through an int16
view, and an MoE router arrives in fp32 inside a bf16 model, as the port's
router parameter is.
"""
from __future__ import annotations

import numpy as np
import torch

from . import gnn, recsys
from .transformer import LMConfig, Transformer


def _flatten(tree, prefix: str = "") -> dict:
    """Dotted names of a tree's leaves; a list's items are named by index."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for key, sub in items:
            out.update(_flatten(sub, f"{prefix}{key}."))
        return out
    return {prefix[:-1]: tree}


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array (bf16 included) as a tensor on ``device``, bits kept."""
    a = np.array(a, order="C")     # a writable copy: leaves may be read-only views
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


@torch.no_grad()
def lm_params_from_numpy(tree: dict, cfg: LMConfig, device="cuda") -> Transformer:
    """The reference's parameter tree (numpy leaves) -> ``Transformer``.
    Raises on a missing or extra leaf, a shape that does not match ``cfg``
    or a dtype other than the port's parameter's (``cfg.dtype``; fp32 for a
    router)."""
    model = Transformer(cfg, device)
    got = {}
    n = cfg.n_scan_layers
    for name, a in _flatten(tree).items():
        if name.startswith("layers."):
            head, rest = name.split(".", 1)
            if a.shape[:1] != (n,):
                raise ValueError(f"{name}: stacked shape {a.shape} does not have "
                                 f"{n} layers on axis 0 (n_layers less n_dense_prefix)")
            got.update({f"{head}.{i}.{rest}": a[i] for i in range(n)})
        else:
            got[name] = a
    return _copy_into(model, got, cfg.name)


def _copy_into(model, got: dict, name: str):
    """Copy the numpy leaves ``got`` (dotted names) into ``model``'s
    parameters of the same names. Raises on a missing or extra leaf, or a
    shape or dtype other than the parameter's."""
    want = dict(model.named_parameters())
    missing, extra = sorted(want.keys() - got.keys()), sorted(got.keys() - want.keys())
    if missing or extra:
        raise ValueError(f"parameter tree does not match {name!r}: missing "
                         f"{missing}, extra {extra}")
    for key, p in want.items():
        t = tensor_from_numpy(got[key], p.device)
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{key}: got {tuple(t.shape)} {t.dtype}, want "
                             f"{tuple(p.shape)} {p.dtype}")
        p.copy_(t)
    return model


@torch.no_grad()
def recsys_params_from_numpy(tree: dict, cfg, device="cuda"):
    """The reference's tree of a recsys model (``dlrm_init``,
    ``deepfm_init``, ``autoint_init`` or ``bert4rec_init``, numpy leaves:
    ``tables`` / ``first`` / ``bot`` / ``top`` / ``mlp`` / ``bias`` /
    ``layers`` / ``head`` / ``item_emb`` / ``pos_emb`` / ``blocks`` /
    ``final_ln``) -> the port's model of ``cfg`` (``models.recsys``).
    Raises as :func:`lm_params_from_numpy`, naming the leaves."""
    return _copy_into(recsys.build(cfg, device), _flatten(tree), cfg.name)


@torch.no_grad()
def sage_params_from_numpy(tree: dict, cfg: gnn.SAGEConfig, device="cuda") -> gnn.SAGE:
    """The reference's GraphSAGE tree (``layers`` of ``w_self`` /
    ``w_nbr``, ``head``; numpy leaves) -> ``models.gnn.SAGE``."""
    return _copy_into(gnn.SAGE(cfg, device), _flatten(tree), cfg.name)
