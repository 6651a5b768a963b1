"""The paper's experiment through the port, one entry per table/figure, as
``benchmarks/run.py`` (same flags, defaults and per-dataset scales):

    python -m repro_torch.paper.run --datasets RAND10M4D --only fig4,fig6 --device cpu
    python -m repro_torch.paper.run --full --datasets SIFT1M   # paper sizes, on the card

CI scale by default (n ~ 2e4); ``--full`` uses the paper's 1e6-1e7 sizes.
Output lines are ``name,key=value,...`` records, as the reference's. The
reference's ``smoke`` bench is not ported (``benchmarks/smoke.py``).
"""
from __future__ import annotations

import argparse
import time

from .._device import resolve_device
from ..data.synthetic import make_ann_dataset
from . import (
    fig3_categories,
    fig4_hierarchy,
    fig5_diversification,
    fig6_comparisons,
    tab1_datasets,
)
from .bench_util import AnnWorld

SCALE_SMALL = {"RAND10M4D": 2e-3, "RAND10M8D": 2e-3, "RAND10M16D": 2e-3,
               "RAND10M32D": 2e-3, "RAND1M": 2e-2, "SIFT1M": 2e-2,
               "GIST1M": 1e-2, "GLOVE1M": 2e-2}
FIGS = {"fig3": fig3_categories, "fig4": fig4_hierarchy,
        "fig5": fig5_diversification, "fig6": fig6_comparisons}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="paper-scale datasets")
    ap.add_argument("--datasets", default="RAND10M4D,RAND10M32D,RAND1M,SIFT1M",
                    help="comma list from repro_torch.data.synthetic.PAPER_DATASETS")
    ap.add_argument("--only", default=None,
                    help="comma list of benches: tab1,fig3,fig4,fig5,fig6")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    if only is not None and "smoke" in only:
        raise SystemExit("the reference's smoke bench is not ported; run "
                         "`python -m benchmarks.smoke` for the JAX package")
    device = resolve_device(args.device)

    def want(b):
        return only is None or b in only

    t0 = time.time()
    if want("tab1"):
        tab1_datasets.run(scale=1.0 if args.full else 0.002, device=device)

    for name in args.datasets.split(","):
        scale = 1.0 if args.full else SCALE_SMALL[name]
        base, queries, metric = make_ann_dataset(name, scale=scale, n_queries=100,
                                                 device=device)
        print(f"# dataset {name}: n={base.shape[0]} d={base.shape[1]} "
              f"metric={metric} ({time.time()-t0:.0f}s)", flush=True)
        world = AnnWorld(base, queries, metric=metric)
        print(world.summary_line(name), flush=True)
        for fig, module in FIGS.items():
            if want(fig):
                module.run(world, name)
        print(f"# done {name} ({time.time()-t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
