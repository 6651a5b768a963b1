"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 48L, d=2048, GQA 32/4 heads,
128 experts top-8 (d_ff=768), vocab 151936. The reference's config with
torch dtypes."""
import torch

from ..models.layers import MoEConfig
from ..models.transformer import LMConfig

ARCH_ID = "qwen3-moe-30b-a3b"
FAMILY = "lm"
FSDP = True            # the reference shards the big weights over "data" too
OPTIMIZER = "adafactor"

CONFIG = LMConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv=4,
    d_head=128,
    d_ff=768,
    vocab=151936,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=768, capacity_factor=1.25),
    rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
    remat=True,
)

SMOKE = LMConfig(
    name="qwen3-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=64, vocab=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32), dtype=torch.float32,
)
