"""Readings for a cell's limits: the program's on many seeds and the
precision control's on a few, in one process on the card.

    python3 annbench/control.py --workload sift1m.search --seeds 11 12 13 \
        --control-seeds 21 22 23 [--batches 1]

For each ``--seeds`` seed the cell's set-up runs, then ``--batches`` batches
(or builds) through the driver's window loop, and the same comparison as a
run prints the program's readings. For each ``--control-seeds`` seed only
the seed's data is drawn, and the controls stand in the program's place
(``Driver.control``: the reference with TF32 products; for a build also the
reference that breaks the index's stated "no self loop"). ``--fault`` plants each
of the faults named (``faults.FAULTS``) in turn under the program's seeds,
over set-up and the window. One JSON line per seed; the limits in
``workloads/<cell>.json`` are set between the two (PERF.md gives them). The
benchmark's own runs never run this.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--batches", type=int, default=1)
    ap.add_argument("--fault", nargs="*", default=[None],
                    help="plant each of these faults (faults.FAULTS) in turn under the "
                         "program's seeds")
    args = ap.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch

    from annbench import harness
    from annbench.faults import plant

    entry, cell, config = harness.load_cell(ROOT, args.workload)
    harness.check_gpu(entry["chips"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    Driver = harness.load_driver(ROOT, cell["driver"])
    dev = torch.device("cuda")
    runs = [("program", fault, seed) for fault in args.fault for seed in args.seeds]
    runs += [("control", None, seed) for seed in args.control_seeds]
    for role, fault, seed in runs:
        t = time.perf_counter()
        drv = Driver(config, cell["params"], seed, dev)
        if role == "program":
            obs = {}
            with plant(drv.kind, fault) if fault else contextlib.nullcontext():
                drv.setup()
                for _ in range(args.batches):
                    drv.window(0.0, obs)     # one batch or build a call
            drv.release()
            readings = drv.check(obs)
            results = {"program": readings}
        else:
            drv.make_data()
            results = drv.control(args.batches)
        for kind, readings in results.items():
            print(json.dumps({"cell": args.workload, "role": kind, "fault": fault,
                              "seed": seed,
                              "seconds": time.perf_counter() - t, **readings}), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
