"""The training loop, as ``repro/train/train_loop.py``: microbatched
gradient accumulation, the optimizer update, periodic atomic checkpoints
and a deterministic resume.

The model is an ``nn.Module`` whose parameters the step trains (a dict of
tensors that require grad also works, as the tests' toy problems use). The
step is eager PyTorch: ``torch.autograd.grad`` of ``loss_fn``, then the
optimizer writes the parameters in place. ``remat`` checkpoints the whole
loss (``torch.utils.checkpoint``, non-reentrant), as the reference's
``jax.checkpoint(loss_fn)``; a model's own ``cfg.remat`` checkpoints each
block.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from . import checkpoint as ckpt_lib
from .optimizer import make_optimizer

LossFn = Callable[[Any, dict], tuple[torch.Tensor, dict]]


def trainable(params) -> dict:
    """The named tensors a step trains: a module's parameters, turned on
    for autograd (serving builds them frozen), or a dict as it is."""
    if isinstance(params, torch.nn.Module):
        params.requires_grad_(True)
        return dict(params.named_parameters())
    return params


def make_train_step(loss_fn: LossFn, opt_update, grad_accum: int = 1, remat: bool = False):
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): metrics {"loss", "grad_norm" where the optimizer returns one,
    and loss_fn's own where grad_accum == 1}. With grad_accum > 1 the batch's
    leading axis is split into that many microbatches, whose gradients are
    summed in fp32 and divided by grad_accum, as is the loss."""
    def lf(params, batch):
        if remat:
            return checkpoint(loss_fn, params, batch, use_reentrant=False)
        return loss_fn(params, batch)

    def grads_of(params, named, batch):
        loss, metrics = lf(params, batch)
        leaves = list(named.values())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), metrics, {
            n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(named.items(), grads)}

    def train_step(params, opt_state, batch):
        named = trainable(params)
        if grad_accum == 1:
            loss, metrics, grads = grads_of(params, named, batch)
            metrics = {k: v.detach() for k, v in (metrics or {}).items()}
        else:
            micro = {k: v.chunk(grad_accum) for k, v in batch.items()}
            gsum, lsum = None, torch.zeros((), dtype=torch.float32)
            for i in range(grad_accum):
                l, _, g = grads_of(params, named, {k: v[i] for k, v in micro.items()})
                if gsum is None:
                    gsum = {n: x.float() for n, x in g.items()}
                    lsum = lsum.to(l.device)
                else:
                    for n, x in g.items():
                        gsum[n] += x
                lsum = lsum + l
            grads = {n: g / grad_accum for n, g in gsum.items()}
            loss, metrics = lsum / grad_accum, {}
        _, opt_state, gnorm = opt_update(grads, opt_state, named)
        out = {"loss": loss}
        if gnorm is not None:
            out["grad_norm"] = gnorm
        out.update(metrics)
        return params, opt_state, out

    return train_step


def fit(*, init_params_fn: Callable[[int], Any], loss_fn: LossFn,
        batch_fn: Callable[[int], dict], steps: int, optimizer: str = "adamw",
        opt_hp: dict | None = None, grad_accum: int = 1, ckpt_dir: str | None = None,
        ckpt_every: int = 50, seed: int = 0, log_every: int = 10,
        remat: bool = False) -> dict:
    """Single-device training with restore-on-start: the newest checkpoint
    under ``ckpt_dir`` (parameters and optimizer state) is loaded before
    the first step, the batch is ``batch_fn(step)`` (a pure function of the
    step), a checkpoint is saved every ``ckpt_every`` steps and at the end.
    Prints ``[train] step N loss=...`` every ``log_every`` steps and at the
    last. Returns {"params", "opt_state", "history": [(step, loss), ...],
    "start": the step resumed at, 0 if none}."""
    opt_init, opt_update = make_optimizer(optimizer, **(opt_hp or {}))
    params = init_params_fn(seed)
    named = trainable(params)
    opt_state = opt_init(named)
    start = 0
    if ckpt_dir:
        restored = ckpt_lib.restore_latest(ckpt_dir, {"params": named, "opt": opt_state})
        if restored is not None:
            start, state, _ = restored
            with torch.no_grad():
                for n, p in named.items():
                    p.copy_(state["params"][n])
            opt_state = state["opt"]
            print(f"[train] resumed at step {start}", flush=True)
    step_fn = make_train_step(loss_fn, opt_update, grad_accum, remat=remat)
    history = []
    t0 = time.time()
    for step in range(start, steps):
        params, opt_state, metrics = step_fn(params, opt_state, batch_fn(step))
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            history.append((step, loss))
            print(f"[train] step {step} loss={loss:.4f} ({time.time() - t0:.1f}s)", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt_lib.save(ckpt_dir, step + 1, {"params": named, "opt": opt_state})
    if ckpt_dir:
        ckpt_lib.save(ckpt_dir, steps, {"params": named, "opt": opt_state})
    return {"params": params, "opt_state": opt_state, "history": history, "start": start}
