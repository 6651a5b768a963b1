"""The dry run on the PyTorch port: every (architecture x input-shape) cell
traced on the production meshes, with the roofline terms per device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --json out.json

It runs in a process of its own (as the reference's must): it initialises a
``fake`` process group of 256 ranks (512 with ``--multi-pod``) in this one
process, builds the production mesh over it, and runs each cell's step
(``configs.common.cell_program``) once on ``meta`` tensors laid out as
DTensors: shapes only, no data, no device. Every rank of a fake group is
rank 0, so the counts are rank 0's, which holds the largest shard where a
dim does not divide.

A ``TorchDispatchMode`` counts below DTensor's dispatch (it declines the
DTensor op, so it sees the local ops each rank runs and the collectives the
redistributions issue, as ``CommDebugMode`` does):

* ``hlo_flops``: the flops of each rank's products (``torch.utils.
  flop_counter``'s formulas on the local shapes: mm, addmm, bmm, baddbmm,
  convolutions) and of the flash-attention kernel (``ops``' meta form:
  2 (dh + dhv) a query-key pair the mask keeps, forward; 2 (3 dh + 2 dhv),
  backward). Elementwise ops and reductions are not counted, where XLA's
  ``cost_analysis`` counts every op, so these counts are at or below the
  reference's;
* ``collectives``, ``collective_bytes``: the output bytes of each
  ``c10d_functional`` collective, by the reference's kinds (all-gather,
  all-reduce, reduce-scatter, all-to-all), as the reference sums each
  collective's result shape;
* ``op_bytes``: the bytes each op reads and writes on the rank (its tensor
  operands and results; views and other metadata ops move none). This is
  an estimate of traffic for ``t_memory_s``, not XLA's ``bytes accessed``:
  it takes no fusion into account, so it is high where XLA would fuse.

The step runs once, every layer through Python (no scan), so
``cost_method`` is "direct" for every cell; the reference extrapolates from
unrolled variants only because XLA counts a loop body once.

The roofline terms take one NVIDIA H100 80GB HBM3 (SXM5, 700 W) a rank:
989e12 dense bf16 FLOP/s and 3.35e12 B/s of HBM3 (NVIDIA H100 Tensor Core
GPU datasheet), and 50e9 B/s a GPU over the network (one 400 Gb/s
ConnectX-7 NDR port a GPU, NVIDIA DGX H100 user guide): a 16-wide mesh axis
spans two 8-GPU nodes, so its collectives cross the network, not NVLink.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import time
import traceback
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import configs
from ..configs import common
from .mesh import PRODUCTION, make_production_mesh

PEAK_FLOPS = 989e12      # dense bf16 FLOP/s, H100 SXM5 (datasheet)
HBM_BW = 3.35e12         # bytes/s, H100 SXM5 HBM3 (datasheet)
NET_BW = 50e9            # bytes/s a GPU: one 400 Gb/s ConnectX-7 port (DGX H100)

COLLECTIVES = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_reduce_coalesced": "all-reduce"}
FREE = {"view", "_unsafe_view", "reshape", "t", "transpose", "permute", "expand", "slice",
        "select", "unsqueeze", "squeeze", "detach", "alias", "as_strided", "split",
        "split_with_sizes", "chunk", "narrow", "unbind", "empty", "empty_strided",
        "empty_like", "new_empty", "new_empty_strided", "_wrap_tensor_autograd",
        "wait_tensor", "lift_fresh", "_local_scalar_dense", "sym_size", "sym_stride",
        "sym_numel", "is_same_size", "unfold", "view_as_real", "view_as_complex"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class MeshShape(NamedTuple):
    """A mesh's axis names and shape: all that the sharding rules and
    ``cell_program`` read, so a cell's arguments and specs need no process
    group."""
    mesh_dim_names: tuple
    shape: tuple


def arg_bytes(prog: common.Program) -> int:
    """The bytes of a program's arguments, whole (a model's parameters)."""
    return sum(sum(p.numel() * p.element_size() for p in a.parameters())
               if isinstance(a, torch.nn.Module) else _nbytes(a) for a in prog.args)


def attention_pairs(S: int, Sk: int, causal: bool, window: int | None) -> int:
    """The query-key pairs a (causal, windowed) mask keeps over S queries
    at the last S of Sk keys."""
    if not causal and window is None:
        return S * Sk
    end = np.arange(Sk - S + 1, Sk + 1, dtype=np.int64)      # query i sees keys < end
    hi = end if causal else np.full_like(end, Sk)
    lo = np.maximum(0, end - window) if window is not None else np.zeros_like(end)
    return int(np.maximum(0, hi - lo).sum())


def flash_flops(q, k, v, causal, window, backward: bool) -> int:
    B, S, H, dh = q.shape
    dhv = v.shape[-1]
    pairs = attention_pairs(S, k.shape[1], causal, window)
    return 2 * B * H * pairs * ((3 * dh + 2 * dhv) if backward else (dh + dhv))


class StepCounter(TorchDispatchMode):
    """Counts the local ops of a step run over DTensors: flops of the
    products and the flash kernel, bytes of each collective kind, and the
    bytes every other op reads and writes."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.op_bytes = 0
        self.collectives: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is DTensor for t in types):
            return NotImplemented     # let DTensor run, then count its local ops
        out = func(*args, **kwargs)
        if types:                     # DTensor's shape inference on fake tensors
            return out
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        if ns == "_c10d_functional" and name in COLLECTIVES:
            kind = COLLECTIVES[name]
            self.collectives[kind] = self.collectives.get(kind, 0) + _nbytes(out)
            return out
        if ns == "repro_torch" and name in ("flash_attention_fwd", "flash_attention_bwd"):
            q, k, v = args[:3]
            causal, window = (args[3], args[4]) if name == "flash_attention_fwd" else \
                (args[5], args[6])
            self.flops += flash_flops(q, k, v, causal, window, name == "flash_attention_bwd")
        elif packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if name not in FREE and not name.startswith("sym_"):
            self.op_bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        return out


def fast_strategy_costs() -> None:
    """Memoize the plans DTensor prices its candidate strategies with: a
    price's plan (its sequence of per-mesh-dim steps) is kept by the two
    layouts alone, not the tensor's shape. The price is summed from the
    steps and the tensor's bytes, so the shape adds nothing to the plan,
    and the plan of a layout with a strided shard is a graph search that
    took 1-2 s a shape on the 2 x 16 x 16 mesh. Every candidate is priced
    as DTensor prices it, so the strategies chosen, and the counts, are
    those of the unpatched run (``tests/test_torch_dryrun.py`` holds a
    16 x 16 cell to it). This replaces ``redistribute_cost`` in the modules
    of ``torch.distributed.tensor`` for the rest of the process."""
    import sys
    from torch.distributed.tensor import _collective_utils, _redistribute

    cost = _collective_utils.redistribute_cost
    if getattr(cost, "fast", False):
        return
    plan = _redistribute._gen_transform_infos
    plans = {}

    def layout_plan(src, dst, *a):
        key = (src.device_mesh, src.placements, src.shard_order, dst.placements,
               dst.shard_order, src.ndim)
        if key not in plans:
            plans[key] = plan(src, dst, *a)
        return plans[key]

    def redistribute_cost(current, target, *a, **k):
        _redistribute._gen_transform_infos = layout_plan
        try:
            return cost(current, target, *a, **k)
        finally:
            _redistribute._gen_transform_infos = plan

    redistribute_cost.fast = True
    for name, mod in list(sys.modules.items()):
        if name.startswith("torch.distributed.tensor") and \
                getattr(mod, "redistribute_cost", None) is cost:
            mod.redistribute_cost = redistribute_cost


def _fake_group(world: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def analyze_cell(arch_id: str, shape: str, mesh, mesh_name: str) -> dict:
    """Run one cell's step on ``mesh`` (over a fake group) and count it."""
    ad = configs.get_arch(arch_id)
    cell = next(c for c in ad.cells() if c.shape == shape)
    rec: dict = {"arch": arch_id, "shape": shape, "kind": cell.kind, "mesh": mesh_name}
    if cell.skip:
        rec["status"] = "skipped"
        rec["skip_reason"] = cell.skip
        return rec
    n_chips = math.prod(tuple(mesh.shape))
    t0 = time.time()
    try:
        prog = common.cell_program(ad, shape, mesh)
        total = arg_bytes(prog)
        args = common.shard_args(prog, prog.args, mesh)
        counter = StepCounter()
        with counter:
            prog.step(*args)
        rec["status"] = "ok"
        rec["step_s"] = round(time.time() - t0, 1)
        rec["arg_bytes_total"] = total
        rec["arg_bytes_per_device"] = total // n_chips
        rec["cost_method"] = "direct"
        rec["hlo_flops"] = float(counter.flops)
        rec["op_bytes"] = float(counter.op_bytes)
        rec["collectives"] = dict(counter.collectives)
        rec["collective_bytes"] = sum(counter.collectives.values())
        rec["t_compute_s"] = counter.flops / PEAK_FLOPS
        rec["t_memory_s"] = counter.op_bytes / HBM_BW
        rec["t_collective_s"] = rec["collective_bytes"] / NET_BW
        rec["bottleneck"] = max(("compute", rec["t_compute_s"]), ("memory", rec["t_memory_s"]),
                                ("collective", rec["t_collective_s"]), key=lambda kv: kv[1])[0]
    except Exception as e:
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def run(cells, meshes) -> list[dict]:
    """Every cell on every mesh (``multi_pod`` flags), the records in cell
    order, each cell's meshes in the order given."""
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    fast_strategy_costs()
    by_mesh = {}
    for mp in meshes:
        shape, _ = PRODUCTION[mp]
        _fake_group(math.prod(shape))
        mesh = make_production_mesh(multi_pod=mp, device_type="cpu")
        name = "x".join(map(str, shape))
        by_mesh[mp] = []
        for c in cells:
            rec = analyze_cell(c.arch, c.shape, mesh, name)
            by_mesh[mp].append(rec)
            status = rec["status"]
            if status == "ok":
                extra = (f"flops={rec['hlo_flops']:.3e} bytes={rec['op_bytes']:.3e} "
                         f"coll={rec['collective_bytes']:.3e} "
                         f"T=(c {rec['t_compute_s']:.2e}|m {rec['t_memory_s']:.2e}|"
                         f"x {rec['t_collective_s']:.2e}) -> {rec['bottleneck']} "
                         f"[step {rec['step_s']}s]")
            elif status == "skipped":
                extra = rec["skip_reason"][:60]
            else:
                extra = rec["error"][:200]
            print(f"[dryrun] {name} {c.arch}:{c.shape} {status} {extra}", flush=True)
        dist.destroy_process_group()
    return [by_mesh[mp][i] for i in range(len(cells)) for mp in meshes]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    cells = [c for c in configs.all_cells()
             if (not args.arch or c.arch == args.arch) and (not args.shape or c.shape == args.shape)]
    if not cells:
        raise SystemExit("no cells selected")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = run(cells, meshes)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {args.json}")
    return results


if __name__ == "__main__":
    main()
