"""H2O-Danube 1.8B [arXiv:2401.16818]: 24L, d=2560, GQA 32/8, d_ff=6912,
vocab 32000, llama+mistral mix with sliding-window attention (4096). The
reference's config with torch dtypes."""
import torch

from ..models.transformer import LMConfig

ARCH_ID = "h2o-danube-1.8b"
FAMILY = "lm"
OPTIMIZER = "adamw"

CONFIG = LMConfig(
    name="h2o-danube-1.8b",
    n_layers=24, d_model=2560, n_heads=32, n_kv=8, d_head=80, d_ff=6912,
    vocab=32000, window=4096, rope_theta=10000.0, dtype=torch.bfloat16,
    remat=True,
)

SMOKE = LMConfig(
    name="danube-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=256,
    window=8, dtype=torch.float32,
)
