"""AutoInt [arXiv:1810.11921]: 39 sparse fields, embed_dim=16, 3 self-attn
layers, 2 heads, d_attn=32. The reference's config with torch dtypes."""
import torch

from ..models import recsys

ARCH_ID = "autoint"
FAMILY = "recsys"
OPTIMIZER = "adamw"

_VOCABS = tuple([1024] * 13 + [
    1461504, 583680, 10131968, 2202624, 512, 512, 12544, 1024, 512, 93312,
    5683712, 8351744, 3194880, 512, 14336, 5461504, 512, 4864, 2048, 512,
    7046656, 512, 512, 286720, 512, 142336,
])

CONFIG = recsys.AutoIntConfig(
    name="autoint", vocab_sizes=_VOCABS, embed_dim=16,
    n_attn_layers=3, n_heads=2, d_attn=32, dtype=torch.float32,
)

SMOKE = recsys.AutoIntConfig(
    name="autoint-smoke", vocab_sizes=tuple([128] * 39), embed_dim=8,
    n_attn_layers=2, n_heads=2, d_attn=8,
)
