"""DeepSeek-V3 671B [arXiv:2412.19437]: 61L, d=7168, MLA (128 heads),
1 shared + 256 routed experts top-8 (d_ff=2048, first 3 layers dense 18432),
MTP, vocab 129280. The reference's config with torch dtypes: its MoE block
is the reference's softmax router (top-8 of 256, capacity_factor 1.25), not
DeepSeek's published sigmoid, group-limited one. The full config holds
671,712,655,360 parameters (~1.25 TiB in bf16), more than one card."""
import torch

from ..models.layers import MLAConfig, MoEConfig
from ..models.transformer import LMConfig

ARCH_ID = "deepseek-v3-671b"
FAMILY = "lm"
FSDP = True            # the reference shards the big weights over "data" too
OPTIMIZER = "adafactor"

CONFIG = LMConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv=128,
    d_head=128,
    d_ff=18432,                   # dense-prefix FFN width
    vocab=129280,
    attention="mla",
    mla=MLAConfig(
        n_heads=128, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=256, top_k=8, d_ff=2048, n_shared=1, shared_d_ff=2048,
        capacity_factor=1.25,
    ),
    n_dense_prefix=3,
    rope_theta=10000.0,
    mtp=True,
    dtype=torch.bfloat16,
    remat=True,
)

SMOKE = LMConfig(
    name="deepseek-v3-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv=4, d_head=16, d_ff=128, vocab=256,
    attention="mla",
    mla=MLAConfig(n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1, shared_d_ff=32),
    n_dense_prefix=1, mtp=True, dtype=torch.float32,
)
