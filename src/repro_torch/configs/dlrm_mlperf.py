"""DLRM MLPerf benchmark config (Criteo 1TB) [arXiv:1906.00091]:
13 dense + 26 sparse features, embed_dim=128, bot 13-512-256-128,
top 1024-1024-512-256-1, dot interaction. The reference's config with torch
dtypes.

Vocab sizes are the Criteo-1TB cardinalities, rounded up to multiples of 512
(production tables are padded for sharding; the hash trick justifies it).
At fp32 the 26 tables hold 187,775,488 rows, 89.5 GiB: more than one card.
``ONE_CARD_ROW_CAP`` is the hash trick's cap that one card takes (ids modulo
the cap), which ``chip_smoke.py`` applies to the five tables above it."""
import torch

from ..models import recsys

ARCH_ID = "dlrm-mlperf"
FAMILY = "recsys"
OPTIMIZER = "adamw"

_CRITEO_1TB = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)
ONE_CARD_ROW_CAP = 1 << 24


def _pad512(v: int) -> int:
    return (v + 511) // 512 * 512


CONFIG = recsys.DLRMConfig(
    name="dlrm-mlperf",
    n_dense=13,
    vocab_sizes=tuple(_pad512(v) for v in _CRITEO_1TB),
    embed_dim=128,
    bot_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
    dtype=torch.float32,
)

SMOKE = recsys.DLRMConfig(
    name="dlrm-smoke",
    n_dense=13, vocab_sizes=tuple([512] * 26), embed_dim=16,
    bot_mlp=(32, 16), top_mlp=(64, 32, 1),
)
