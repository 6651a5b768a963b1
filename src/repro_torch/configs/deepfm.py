"""DeepFM [arXiv:1703.04247]: 39 sparse fields, embed_dim=10, MLP 400-400-400,
FM interaction. Criteo-Kaggle-like field cardinalities (padded to 512). The
reference's config with torch dtypes."""
import torch

from ..models import recsys

ARCH_ID = "deepfm"
FAMILY = "recsys"
OPTIMIZER = "adamw"

# 39 fields: 13 bucketized-dense + 26 categorical (Criteo-Kaggle scale)
_VOCABS = tuple([1024] * 13 + [
    1461504, 583680, 10131968, 2202624, 512, 512, 12544, 1024, 512, 93312,
    5683712, 8351744, 3194880, 512, 14336, 5461504, 512, 4864, 2048, 512,
    7046656, 512, 512, 286720, 512, 142336,
])

CONFIG = recsys.DeepFMConfig(
    name="deepfm", vocab_sizes=_VOCABS, embed_dim=10, mlp=(400, 400, 400),
    dtype=torch.float32,
)

SMOKE = recsys.DeepFMConfig(
    name="deepfm-smoke", vocab_sizes=tuple([128] * 39), embed_dim=4,
    mlp=(16, 16),
)
