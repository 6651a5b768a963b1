"""AdamW and Adafactor over dicts of tensors, as ``repro/train/optimizer.py``.

Parameters, gradients and optimizer state are plain dicts keyed by the
model's parameter names (``dict(model.named_parameters())``), so state is
a tree of tensors a checkpoint writes as it is. Every update is computed in
fp32 and cast back to the parameter's dtype, then written into the
parameter in place (the reference returns new arrays; writing in place
keeps the ``nn.Module`` and frees the old weights). AdamW keeps fp32 m and
v per parameter and writes them in place too; Adafactor keeps, per leaf of the reference's tree
(:func:`leaves`: the stacked layers' parameters are one leaf, as the
reference stacks them), factored second moments where the leaf has two or
more dimensions (row and column statistics over the last two axes, so an
(E, D, F) expert tensor keeps (E, D) and (E, F), and the stacked (L, D)
norm scales keep (L,) and (D,)) and a full one for the rest, with no first
moment, and clips each leaf's update to RMS ``clip_threshold``; its state is
keyed by those leaves.

A leaf is updated in parts where it is large, so its fp32 temporaries never
need a second copy of it: a stacked leaf layer by layer, a tensor of three
or more dimensions in slices of at most ``CHUNK`` elements along axis 0
(DeepSeek-V3's (256, 7168, 2048) experts, 3.8e9 each), a matrix past
``CHUNK`` in slices of rows (its column statistic summed over them). The
update's RMS then comes from a sum over the parts, which sums in another
order than the reference's one mean.
"""
from __future__ import annotations

import torch

CHUNK = 2**28


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))


def clip_by_global_norm(grads: dict, max_norm: float) -> tuple[dict, torch.Tensor]:
    """(grads scaled by min(1, max_norm / max(norm, 1e-9)) in fp32, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return {n: g.float() * scale for n, g in grads.items()}, norm


# -- AdamW ---------------------------------------------------------------------


def adamw_init(params: dict) -> dict:
    """{step: int32 0, m: fp32 zeros like each parameter, v: the same}."""
    dev = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for n, p in params.items()},
            "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for n, p in params.items()}}


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict, lr: float = 3e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0):
    """-> (params, state, grad_norm): gradients clipped to ``max_grad_norm``
    by their global norm; bias-corrected Adam with decoupled weight decay.
    The parameters and the state's m and v are written in place, one
    parameter at a time (each gradient scaled as it is used), so a step
    holds one copy of the state and of the gradients: the temporaries are
    those of the largest parameter (a DLRM table). The returned state
    holds the same m and v tensors and a new step."""
    norm = global_norm(grads)
    scale = torch.clamp(max_grad_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    step = state["step"] + 1
    t = step.float()
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    for n, p in params.items():
        g32 = grads[n].float() * scale
        m, v = state["m"][n], state["v"][n]
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * torch.square(g32))
        del g32
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p32 = p.float()
        p.copy_((p32 - lr * (u + weight_decay * p32)).to(p.dtype))
    return params, {"step": step, "m": state["m"], "v": state["v"]}, norm


# -- Adafactor -----------------------------------------------------------------


def leaves(params: dict) -> dict[str, list[str]]:
    """The reference's leaves over the port's parameter names: the
    ``layers.{i}.X`` of the stacked layers form one leaf ``layers.X`` (the
    reference stacks them on a new axis 0 and scans), every other parameter
    (the embedding, the head, the dense prefix, the MTP head) is a leaf of
    its own. Adafactor's statistics and update clipping are per leaf, so
    they follow this layout; AdamW is elementwise and does not need it."""
    out: dict[str, list[str]] = {}
    for name in params:
        parts = name.split(".")
        stacked = len(parts) > 2 and parts[0] == "layers" and parts[1].isdigit()
        out.setdefault("layers." + ".".join(parts[2:]) if stacked else name, []).append(name)
    return out


def _leaf_shape(key: str, names: list, params: dict) -> tuple:
    shape = tuple(params[names[0]].shape)
    return (len(names), *shape) if key != names[0] else shape


def adafactor_init(params: dict) -> dict:
    """{step, vr, vc} keyed by :func:`leaves`: for a leaf of >= 2 dims its
    row statistic (shape[:-1]) and column statistic (shape[:-2] +
    shape[-1:]); else vr like the leaf and vc a (1,) placeholder. fp32."""
    dev = next(iter(params.values())).device
    vr, vc = {}, {}
    for key, names in leaves(params).items():
        shape = _leaf_shape(key, names, params)
        factored = len(shape) >= 2
        vr[key] = torch.zeros(shape[:-1] if factored else shape, dtype=torch.float32, device=dev)
        vc[key] = torch.zeros(shape[:-2] + shape[-1:] if factored else (1,),
                              dtype=torch.float32, device=dev)
    return {"step": torch.zeros((), dtype=torch.int32, device=dev), "vr": vr, "vc": vc}


def _apply(p: torch.Tensor, u: torch.Tensor, div, lr, weight_decay) -> None:
    """p <- p - lr * (u / div + wd * p) in fp32, cast back to p's dtype."""
    p32 = p.float()
    p.copy_((p32 - lr * (u / div + weight_decay * p32)).to(p.dtype))


def _vector(p, g, vr, vc, beta, lr, eps, clip_threshold, weight_decay):
    """A 1-D leaf: a full second moment."""
    g32 = g.float()
    vr_n = beta * vr + (1 - beta) * (torch.square(g32) + eps)
    u = g32 * torch.rsqrt(torch.clamp_min(vr_n, eps))
    rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
    _apply(p, u, torch.clamp_min(rms / clip_threshold, 1.0), lr, weight_decay)
    return vr_n, vc


def _rows(p, g, vr, vc, beta, lr, eps, clip_threshold, weight_decay):
    """A 2-D leaf (R, C), in slices of rows when past CHUNK elements (the
    column statistic then summed over them)."""
    per = max(1, CHUNK // max(1, p.shape[-1]))
    if p.shape[0] <= per:
        g32 = g.float()
        g2 = torch.square(g32) + eps
        vr_n = beta * vr + (1 - beta) * g2.mean(dim=-1)
        vc_n = beta * vc + (1 - beta) * g2.mean(dim=-2)
        denom = vr_n[:, None] * vc_n[None, :] / torch.clamp_min(vr_n.mean(dim=-1), eps)
        u = g32 * torch.rsqrt(torch.clamp_min(denom, eps))
        rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
        _apply(p, u, torch.clamp_min(rms / clip_threshold, 1.0), lr, weight_decay)
        return vr_n, vc_n
    slices = [slice(i, i + per) for i in range(0, p.shape[0], per)]
    vr_n, col = torch.empty_like(vr), torch.zeros_like(vc)
    for sl in slices:
        g2 = torch.square(g[sl].float()) + eps
        vr_n[sl] = beta * vr[sl] + (1 - beta) * g2.mean(dim=-1)
        col += g2.sum(dim=-2)
    vc_n = beta * vc + (1 - beta) * (col / p.shape[0])
    row_mean = torch.clamp_min(vr_n.mean(dim=-1), eps)

    def update(sl):
        denom = vr_n[sl, None] * vc_n[None, :] / row_mean
        return g[sl].float() * torch.rsqrt(torch.clamp_min(denom, eps))

    sq = sum(torch.sum(torch.square(update(sl))) for sl in slices)
    div = torch.clamp_min(torch.sqrt(sq / p.numel() + eps) / clip_threshold, 1.0)
    for sl in slices:
        _apply(p[sl], update(sl), div, lr, weight_decay)
    return vr_n, vc_n


def _matrices(parts, beta, lr, eps, clip_threshold, weight_decay):
    """A leaf of >= 3 dims as parts of whole (R, C) matrices: (p, g, vr,
    vc, vr_out, vc_out) views, whose statistics are independent; the
    update's RMS is over all of them."""
    for p, g, vr, vc, vr_out, vc_out in parts:
        g2 = torch.square(g.float()) + eps
        vr_out.copy_(beta * vr + (1 - beta) * g2.mean(dim=-1))
        vc_out.copy_(beta * vc + (1 - beta) * g2.mean(dim=-2))

    def update(part):
        p, g, _, _, vr_n, vc_n = part
        denom = (vr_n[..., :, None] * vc_n[..., None, :]
                 / torch.clamp_min(vr_n.mean(dim=-1)[..., None, None], eps))
        return g.float() * torch.rsqrt(torch.clamp_min(denom, eps))

    if len(parts) == 1:
        u = update(parts[0])
        rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
        _apply(parts[0][0], u, torch.clamp_min(rms / clip_threshold, 1.0), lr, weight_decay)
        return
    numel = sum(part[0].numel() for part in parts)
    sq = sum(torch.sum(torch.square(update(part))) for part in parts)
    div = torch.clamp_min(torch.sqrt(sq / numel + eps) / clip_threshold, 1.0)
    for part in parts:
        _apply(part[0], update(part), div, lr, weight_decay)


def _matrix_parts(ps, gs, stacked, vr, vc, vr_n, vc_n) -> list:
    """A >= 3-D leaf's parts: each stacked layer's tensor, or the leaf; each
    cut along its axis 0 where it has >= 3 dims and more than CHUNK
    elements (DeepSeek-V3's (E, D, F) experts)."""
    units = ([(p, g, vr[i], vc[i], vr_n[i], vc_n[i]) for i, (p, g) in enumerate(zip(ps, gs))]
             if stacked else [(ps[0], gs[0], vr, vc, vr_n, vc_n)])
    parts = []
    for unit in units:
        p = unit[0]
        if p.dim() < 3 or p.numel() <= CHUNK:
            parts.append(unit)
            continue
        per = max(1, CHUNK // (p.numel() // p.shape[0]))
        parts += [tuple(x[i:i + per] for x in unit) for i in range(0, p.shape[0], per)]
    return parts


@torch.no_grad()
def adafactor_update(grads: dict, state: dict, params: dict, lr: float = 1e-3,
                     decay: float = 0.8, eps: float = 1e-30, clip_threshold: float = 1.0,
                     weight_decay: float = 0.0):
    """-> (params, state, None): beta = 1 - step ** -decay, statistics and
    update clipping per :func:`leaves` leaf; the parameters written in
    place, the state new. No gradient clipping (the reference returns no
    norm)."""
    step = state["step"] + 1
    beta = 1.0 - step.float() ** -decay
    grads = dict(grads)   # popped leaf by leaf, so each is freed once used
    hp = (beta, lr, eps, clip_threshold, weight_decay)
    new_vr, new_vc = {}, {}
    for key, names in leaves(params).items():
        ps = [params[n] for n in names]
        gs = [grads.pop(n) for n in names]
        vr, vc = state["vr"][key], state["vc"][key]
        stacked = key != names[0]
        ndim = ps[0].dim() + stacked
        if ndim == 1:
            new_vr[key], new_vc[key] = _vector(ps[0], gs[0], vr, vc, *hp)
        elif ndim == 2 and stacked:   # per-layer vectors (norm scales), stacked
            leaf = torch.stack(ps)
            new_vr[key], new_vc[key] = _rows(leaf, torch.stack(gs), vr, vc, *hp)
            for i, p in enumerate(ps):
                p.copy_(leaf[i])
        elif ndim == 2:
            new_vr[key], new_vc[key] = _rows(ps[0], gs[0], vr, vc, *hp)
        else:
            new_vr[key], new_vc[key] = torch.empty_like(vr), torch.empty_like(vc)
            _matrices(_matrix_parts(ps, gs, stacked, vr, vc, new_vr[key], new_vc[key]), *hp)
    return params, {"step": step, "vr": new_vr, "vc": new_vc}, None


def make_optimizer(name: str, **hp):
    """(init, update) by name, ``hp`` bound as the update's keywords; the
    defaults are the reference's."""
    if name == "adamw":
        return adamw_init, lambda g, s, p: adamw_update(g, s, p, **hp)
    if name == "adafactor":
        return adafactor_init, lambda g, s, p: adafactor_update(g, s, p, **hp)
    raise ValueError(f"unknown optimizer {name}")
