"""End-to-end training on the PyTorch port, the counterpart of
``examples/train_lm.py`` with its flags, configs and assert: a ~4M (or,
with ``--params-100m``, ~100M) parameter TinyLlama-family model in fp32
trained for a few hundred steps on the synthetic token stream, with
checkpoints and deterministic resume (``train.train_loop.fit``).

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200 [--params-100m]   # one GPU
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 40

It resumes from the newest checkpoint under ``--ckpt-dir`` where one is
(default: ``repro_torch_lm_ckpt`` in the temp directory), as the
reference's does.
"""
import argparse
import math
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.data.synthetic import lm_batch_for_step  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train.train_loop import fit  # noqa: E402


def config(params_100m: bool) -> tuple[T.LMConfig, int, int]:
    """(config, batch, seq): the reference example's two sizes."""
    if params_100m:
        return T.LMConfig(name="demo-100m", n_layers=12, d_model=768, n_heads=12, n_kv=4,
                          d_head=64, d_ff=2048, vocab=32000, dtype=torch.float32), 8, 512
    return T.LMConfig(name="demo-4m", n_layers=4, d_model=256, n_heads=4, n_kv=2, d_head=64,
                      d_ff=512, vocab=512, dtype=torch.float32), 16, 64


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--params-100m", action="store_true",
                    help="~100M params (slow on CPU; default is a 4M model)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, batch, seq = config(args.params_100m)

    out = fit(
        init_params_fn=lambda seed: T.init_params(cfg, seed, dev),
        loss_fn=T.loss_fn,
        batch_fn=lambda s: lm_batch_for_step(0, s, batch, seq, cfg.vocab, dev),
        steps=args.steps,
        optimizer="adamw",
        opt_hp={"lr": 1e-3},
        ckpt_dir=args.ckpt_dir,
        ckpt_every=50,
        log_every=20,
    )
    hist = out["history"]
    print(f"loss: {hist[0][1]:.3f} -> {hist[-1][1]:.3f} "
          f"(expect well below ln(vocab)={math.log(cfg.vocab):.2f})")
    assert hist[-1][1] < hist[0][1], "loss must decrease"
    return out


if __name__ == "__main__":
    main()
