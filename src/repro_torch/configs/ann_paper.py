"""The paper's own experiment configurations (Tab. I + Secs. IV-V), as the
reference's ``repro/configs/ann_paper.py``.

One entry per dataset with the index parameters used across Figs. 3-6, so
``repro_torch.paper`` and external users build exactly the graphs the study
compares: a shared NN-Descent graph (KGraph), its GD- and DPG-diversified
versions, and an HNSW index whose bottom layer reuses that same graph."""
from __future__ import annotations

import dataclasses

from ..data.synthetic import PAPER_DATASETS


@dataclasses.dataclass(frozen=True)
class AnnExperimentConfig:
    dataset: str
    metric: str
    knn_k: int = 20              # KGraph degree ("several tens", Sec. III)
    gd_max_keep: int | None = None   # default L/2 (paper Sec. IV)
    hnsw_m: int = 16
    efs: tuple[int, ...] = (8, 16, 32, 64, 128)
    n_seeds: int = 8             # flat-search random entries


def paper_experiment(dataset: str) -> AnnExperimentConfig:
    spec = PAPER_DATASETS[dataset]
    # higher-degree graphs for the high-LID datasets (KGraph quality needs
    # K ~ LID-dependent headroom)
    hard = spec["paper_lid"] >= 19
    return AnnExperimentConfig(
        dataset=dataset,
        metric=spec["metric"],
        knn_k=32 if hard else 20,
        hnsw_m=16 if hard else 12,
        efs=(16, 32, 64, 128, 256) if hard else (8, 16, 32, 64, 128),
    )


ALL_EXPERIMENTS = {name: paper_experiment(name) for name in PAPER_DATASETS}
