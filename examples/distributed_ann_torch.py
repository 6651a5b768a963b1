"""Distributed shard-and-merge ANN search on the PyTorch port, with a lost
shard: the counterpart of ``examples/distributed_ann.py``. Each shard builds
its own NN-Descent + GD graph over its rows; a dead shard degrades recall,
never the service.

    PYTHONPATH=src python examples/distributed_ann_torch.py             # one GPU
    PYTHONPATH=src python examples/distributed_ann_torch.py --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/distributed_ann_torch.py --device cpu

With as many ranks as shards (``torchrun``: gloo on the CPU, nccl with one
GPU a rank) every rank builds and searches its own shard through
``distributed_search``; otherwise one process runs the shards one after
another through ``emulated_shard_search``, the same beam and merge. Prints
recall@1 for dead=0 and dead=1 (rank 0 only).
"""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.core import bruteforce  # noqa: E402
from repro_torch.core.engine import SearchSpec, emulated_shard_search, shard_entries  # noqa: E402
from repro_torch.distributed.sharded_ann import (  # noqa: E402
    build_shard,
    distributed_search,
    shard_graph,
    shard_graph_spec,
)
from repro_torch.launch.mesh import make_flat_group  # noqa: E402


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--q", type=int, default=100)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if "LOCAL_RANK" in os.environ and not dist.is_initialized():
        # a torchrun rank: the launcher's environment names the group
        if args.device == "cpu":
            dist.init_process_group("gloo")
        else:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
            args.device = f"cuda:{os.environ['LOCAL_RANK']}"
            dist.init_process_group("nccl")
    dev = resolve_device(args.device)
    fg = make_flat_group(dev)

    rng = np.random.default_rng(args.seed)
    base = torch.from_numpy(rng.random((args.n, args.d), dtype=np.float32)).to(dev)
    queries = torch.from_numpy(rng.random((args.q, args.d), dtype=np.float32)).to(dev)
    gt = bruteforce.ground_truth(queries, base, 1)

    P = args.shards
    per = args.n // P
    sharded = fg.size == P
    if sharded:   # this rank's own shard only
        res = build_shard(base, P, fg.rank, spec=shard_graph_spec(), seed=args.seed)
        bs = base[None, fg.rank * per:(fg.rank + 1) * per]
        ns = res.graph.neighbors[None]
    else:
        bs, ns = shard_graph(base, None, P, rebuild=True, seed=args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ent = shard_entries(gen, P, args.q, per, 8)
    spec = SearchSpec(ef=48, k=1)

    for dead in (0, 1):
        live = torch.ones((P,), dtype=torch.bool, device=dev)
        if dead:
            live[0] = False   # a simulated node loss or straggler
        if sharded:
            r = slice(fg.rank, fg.rank + 1)
            _, ids, comps = distributed_search(queries, bs, ns, ent[r], live[r], ef=spec.ef,
                                               k=spec.k, group=fg.group)
            mode = f"distributed_search over {fg.size} ranks"
        else:
            _, ids, comps = emulated_shard_search(queries, bs, ns, ent, live, spec)
            mode = "emulated_shard_search in one process"
        recall = float((ids[:, 0] == gt[:, 0]).float().mean())
        if fg.rank == 0:
            print(f"shards={P} dead={dead}: recall@1={recall:.3f}, comps/query "
                  f"{float(comps.float().mean()):.1f} ({mode}; {dev})", flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
