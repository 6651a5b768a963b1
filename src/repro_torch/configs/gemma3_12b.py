"""Gemma3-12B [hf:google/gemma-3; unverified tier]: 48L, d=3840, GQA 16/8
(d_head=256), d_ff=15360, vocab 262144, 5 local (window 1024) : 1 global
pattern, 128k context. The reference's config with torch dtypes."""
import torch

from ..models.transformer import LMConfig

ARCH_ID = "gemma3-12b"
FAMILY = "lm"
FSDP = True            # the reference shards the big weights over "data" too
OPTIMIZER = "adamw"

CONFIG = LMConfig(
    name="gemma3-12b",
    n_layers=48, d_model=3840, n_heads=16, n_kv=8, d_head=256, d_ff=15360,
    vocab=262144, local_global=6, local_window=1024,
    rope_theta=1_000_000.0, dtype=torch.bfloat16, remat=True,
)

SMOKE = LMConfig(
    name="gemma3-smoke",
    n_layers=6, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=256,
    local_global=3, local_window=8, dtype=torch.float32,
)
