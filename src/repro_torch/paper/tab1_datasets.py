"""Paper Tab. I: dataset roster + LID estimates (Levina-Bickel MLE), as
``benchmarks/tab1_datasets.py``.

Validates C5: LID of uniform synthetic data ~ d/1.5-d/2, and that the
manifold stand-ins land near their real-data targets."""
from __future__ import annotations

import time

from ..core.lid import lid_mle
from ..data.synthetic import PAPER_DATASETS, make_ann_dataset


def run(scale: float = 0.002, out=print, names=None, device="cuda"):
    """One ``tab1/`` line per dataset (default: all of PAPER_DATASETS)."""
    rows = []
    for name in names or PAPER_DATASETS:
        spec = PAPER_DATASETS[name]
        t0 = time.time()
        base, _, metric = make_ann_dataset(name, scale=scale, n_queries=16, device=device)
        est = float(lid_mle(base, k=20, sample=min(1500, base.shape[0]), metric="l2"))
        rows.append((name, base.shape[0], spec["d"], metric, spec["paper_lid"],
                     est, time.time() - t0))
        out(
            f"tab1/{name},n={base.shape[0]},d={spec['d']},metric={metric},"
            f"paper_lid={spec['paper_lid']},est_lid={est:.1f}"
        )
    return rows
