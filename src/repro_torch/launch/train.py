"""LM training on the PyTorch port, the counterpart of the reference's
``launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --smoke --steps 30 --device cpu [--ckpt-dir DIR --ckpt-every 25]

As the reference's, it trains under a mesh (``launch/mesh.py``): the
(1, 1) test mesh with ``--smoke`` (``--multi-pod`` is still refused
without its 512 ranks); else the production mesh where the
process group has its 256 ranks (512 with ``--multi-pod``), or the (1, 1)
mesh with the same specs on a one-rank world. Any other rank count, and
``--multi-pod`` without 512 ranks, is refused by the count it needs. On a
one-rank mesh the step is the plain one-device step (``train_loop.fit``);
on a larger mesh it is ``configs.common.cell_program``'s train step on the
parameters, optimizer state and batches laid out as DTensors, each rank
holding only its shards of the weights and the optimizer state (and one
whole parameter at a time while the weights are drawn).

The model comes from ``--seed`` (random weights, bf16 at published widths;
``--smoke`` takes the arch's reduced fp32 config), the arch's optimizer at
the reference's defaults (AdamW for TinyLlama, Danube and Gemma3;
Adafactor for Qwen3 and DeepSeek-V3), ``models.transformer.loss_fn`` (with
the MoE aux and the MTP term where the arch has them) on ``--batch`` x
``--seq`` tokens of ``data.synthetic.lm_batch_for_step(seed, step, ...)``,
a pure function of the step. It prints ``[train] step N loss=...`` every 10
steps and at the last; with ``--ckpt-dir`` (one-rank mesh) it resumes from
the newest checkpoint there, saves every ``--ckpt-every`` steps and at the
end. As the reference's, this CLI drives the LM archs only; the recsys and
GNN archs are served by ``launch/serve.py`` and trained by
``configs.common``'s train steps (``cell_train_step``, one per train cell;
``chip_smoke.py`` phase 15 runs them on the card).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import time

import torch.distributed as dist

from .. import configs
from .._device import resolve_device
from ..configs import common
from ..data.synthetic import lm_batch_for_step
from ..distributed import sharding
from ..models import transformer as T
from ..train.train_loop import fit
from .mesh import PRODUCTION, make_production_mesh, make_test_mesh

LOG_EVERY = 10


def _arch(name: str) -> str:
    if name in configs.list_archs("lm"):
        return name
    raise argparse.ArgumentTypeError(
        f"{name!r}: train.py drives the LM archs ({', '.join(configs.list_archs('lm'))}); "
        "the recsys and GNN archs are served by launch/serve.py and trained by "
        "configs.common's train steps (cell_train_step; chip_smoke.py phase 15)")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, type=_arch,
                    help=f"an LM: {', '.join(configs.list_archs('lm'))}")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced config")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2 x 16 x 16 mesh (needs a 512-rank process group)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0, help="seeds the weights and the data")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def train_mesh(args: argparse.Namespace):
    """``--multi-pod`` without its 512 ranks is refused; then the (1, 1)
    mesh with ``--smoke``, as the reference's; else the production mesh
    where the world has its rank count (512 with ``--multi-pod``, else
    256), else the (1, 1) mesh on a one-rank world. Raises naming the rank
    count it needs."""
    dev = resolve_device(args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = math.prod(PRODUCTION[args.multi_pod][0])
    if args.multi_pod and world != need:
        raise RuntimeError(f"--multi-pod needs {need} ranks; the process group has {world}")
    if args.smoke or world == 1:
        return make_test_mesh((1, 1), device_type=dev.type)
    if world != need:
        raise RuntimeError(f"the production mesh needs {need} ranks; the process group has "
                           f"{world}")
    return make_production_mesh(multi_pod=args.multi_pod, device_type=dev.type)


def train_lm(args: argparse.Namespace, mesh=None) -> dict:
    """Run the CLI's training under ``mesh`` (:func:`train_mesh` where
    None): ``train_loop.fit`` on a one-rank mesh, :func:`_train_sharded` on
    a larger one; returns {params, opt_state, history, start}."""
    dev = resolve_device(args.device)
    ad = configs.get_arch(args.arch)
    cfg = ad.smoke_cfg if args.smoke else ad.model_cfg
    mesh = train_mesh(args) if mesh is None else mesh
    if mesh.size() > 1:
        return _train_sharded(args, dataclasses.replace(ad, model_cfg=cfg), mesh)
    return fit(init_params_fn=lambda seed: T.init_params(cfg, seed, dev), loss_fn=T.loss_fn,
               batch_fn=lambda step: lm_batch_for_step(args.seed, step, args.batch, args.seq,
                                                       cfg.vocab, dev),
               steps=args.steps, optimizer=ad.optimizer, ckpt_dir=args.ckpt_dir,
               ckpt_every=args.ckpt_every, seed=args.seed, log_every=LOG_EVERY)


def _train_sharded(args, ad, mesh) -> dict:
    """``cell_program``'s train step over ``mesh`` at ``--batch`` x
    ``--seq``: every rank draws the same weights from the seed, one
    parameter at a time, and keeps only its shards (``init_params``'
    ``shard``); the optimizer state is allocated shard by shard; the
    batches are drawn whole and laid out by the batch spec."""
    if args.ckpt_dir:
        raise RuntimeError("--ckpt-dir: checkpoints are written by the one-rank path only")
    dev = resolve_device(args.device)
    with _train_shape(args.batch, args.seq):
        prog = common.cell_program(ad, "train_4k", mesh)
    model_specs, opt_specs, batch_specs = prog.specs
    model = T.init_params(prog.args[0].cfg, args.seed, dev,
                          shard=lambda name, w: sharding.shard(w, mesh, model_specs[name]))
    opt_state = sharding.zeros_tree(prog.args[1], opt_specs, mesh)
    history, t0 = [], time.time()
    for step in range(args.steps):
        batch = sharding.shard_tree(
            lm_batch_for_step(args.seed, step, args.batch, args.seq, ad.model_cfg.vocab, dev),
            batch_specs, mesh)
        opt_state, loss = prog.step(model, opt_state, batch)
        if step % LOG_EVERY == 0 or step == args.steps - 1:
            loss = float(loss.full_tensor())
            history.append((step, loss))
            print(f"[train] step {step} loss={loss:.4f} ({time.time() - t0:.1f}s)", flush=True)
    return {"params": model, "opt_state": opt_state, "history": history, "start": 0}


@contextlib.contextmanager
def _train_shape(batch: int, seq: int):
    """``LM_SHAPES["train_4k"]`` at the CLI's batch and sequence while a
    program is built (the reference's launcher sets it likewise)."""
    old = common.LM_SHAPES["train_4k"]
    common.LM_SHAPES["train_4k"] = dict(seq=seq, batch=batch)
    try:
        yield
    finally:
        common.LM_SHAPES["train_4k"] = old


def main(argv=None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    try:
        mesh = train_mesh(args)
    except RuntimeError as e:
        ap.error(str(e))
    return train_lm(args, mesh)


if __name__ == "__main__":
    main()
