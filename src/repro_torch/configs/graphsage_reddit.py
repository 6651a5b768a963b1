"""GraphSAGE [arXiv:1706.02216]: 2 layers, d_hidden=128, mean aggregator,
sample sizes 25-10 (minibatch_lg uses the assigned 15-10 fanout). The
reference's config with torch dtypes."""
import torch

from ..models import gnn

ARCH_ID = "graphsage-reddit"
FAMILY = "gnn"
OPTIMIZER = "adamw"

CONFIG = gnn.SAGEConfig(
    name="graphsage-reddit",
    n_layers=2, d_in=602, d_hidden=128, n_classes=41,
    fanouts=(25, 10), aggregator="mean", dtype=torch.float32,
)

SMOKE = gnn.SAGEConfig(
    name="graphsage-smoke",
    n_layers=2, d_in=16, d_hidden=8, n_classes=4, fanouts=(4, 3),
)
