"""TinyLlama 1.1B [arXiv:2401.02385]: 22L, d=2048, GQA 32/4, d_ff=5632,
vocab 32000 (llama2 arch). The reference's config with torch dtypes."""
import torch

from ..models.transformer import LMConfig

ARCH_ID = "tinyllama-1.1b"
FAMILY = "lm"
OPTIMIZER = "adamw"

CONFIG = LMConfig(
    name="tinyllama-1.1b",
    n_layers=22, d_model=2048, n_heads=32, n_kv=4, d_head=64, d_ff=5632,
    vocab=32000, rope_theta=10000.0, dtype=torch.bfloat16, remat=True,
)

SMOKE = LMConfig(
    name="tinyllama-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=256,
    dtype=torch.float32,
)
