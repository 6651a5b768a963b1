"""LM training on the PyTorch port, the counterpart of the reference's
``launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --smoke --steps 30 --device cpu [--ckpt-dir DIR --ckpt-every 25]

One device (``--device cuda``, the default, raises without a GPU): the
model from ``--seed`` (random weights, bf16 at published widths; ``--smoke``
takes the arch's reduced fp32 config), the arch's optimizer at the
reference's defaults (AdamW for TinyLlama, Danube and Gemma3; Adafactor for
Qwen3 and DeepSeek-V3), ``models.transformer.loss_fn`` (with the MoE aux
and the MTP term where the arch has them) on ``--batch`` x ``--seq`` tokens
of ``data.synthetic.lm_batch_for_step(seed, step, ...)``, a pure function
of the step. It prints ``[train] step N loss=...`` every 10 steps and at the
last; with ``--ckpt-dir`` it resumes from the newest checkpoint there,
saves every ``--ckpt-every`` steps and at the end. The reference's
production meshes (``--multi-pod``) are refused: the port trains on one
device, and the LM meshes are not ported yet. As the reference's, this CLI
drives the LM archs only; the recsys and GNN archs are served by
``launch/serve.py`` and trained by ``configs.common``'s train steps
(``cell_train_step``, one per train cell; ``chip_smoke.py`` phase 15 runs
them on the card).
"""
from __future__ import annotations

import argparse

from .. import configs
from .._device import resolve_device
from ..data.synthetic import lm_batch_for_step
from ..models import transformer as T
from ..train.train_loop import fit

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
                    help="refused: the port trains on one device (the LM meshes are not "
                         "ported yet)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0, help="seeds the weights and the data")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def train_lm(args: argparse.Namespace) -> dict:
    """Run the CLI's training through ``train_loop.fit``; returns its dict
    (params, opt_state, history, start)."""
    dev = resolve_device(args.device)
    ad = configs.get_arch(args.arch)
    cfg = ad.smoke_cfg if args.smoke else ad.model_cfg
    return fit(init_params_fn=lambda seed: T.init_params(cfg, seed, dev), loss_fn=T.loss_fn,
               batch_fn=lambda step: lm_batch_for_step(args.seed, step, args.batch, args.seq,
                                                       cfg.vocab, dev),
               steps=args.steps, optimizer=ad.optimizer, ckpt_dir=args.ckpt_dir,
               ckpt_every=args.ckpt_every, seed=args.seed, log_every=LOG_EVERY)


def main(argv=None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    if args.multi_pod:
        ap.error("--multi-pod: the port trains on one device; the reference's LM meshes "
                 "are not ported yet")
    return train_lm(args)


if __name__ == "__main__":
    main()
