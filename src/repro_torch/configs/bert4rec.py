"""BERT4Rec [arXiv:1904.06690]: embed_dim=64, 2 blocks, 2 heads, seq_len=200,
bidirectional masked-item modeling (ML-20M item universe). The reference's
config with torch dtypes."""
import torch

from ..models import recsys

ARCH_ID = "bert4rec"
FAMILY = "recsys"
OPTIMIZER = "adamw"

CONFIG = recsys.Bert4RecConfig(
    name="bert4rec", n_items=54546, embed_dim=64, n_blocks=2, n_heads=2,
    seq_len=200, dtype=torch.float32,
)

SMOKE = recsys.Bert4RecConfig(
    name="bert4rec-smoke", n_items=512, embed_dim=16, n_blocks=2, n_heads=2,
    seq_len=16,
)
