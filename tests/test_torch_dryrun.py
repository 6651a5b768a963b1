"""The port's dry run and roofline (``launch/dryrun.py``,
``launch/roofline.py``) on the CPU against live calls into ``repro``.

* ``arg_bytes_total`` of every cell equals the bytes of the reference's
  ``build_lowerable(ad, shape, make_test_mesh((1, 1))).args`` leaves, byte
  for byte, but for the named leaves the port does not hold
  (``ONLY_IN_REFERENCE``: the minibatch cell's (2,) uint32 ``key``, 8
  bytes; the port's sampler draws from a generator).
* ``lm_param_counts`` and ``model_flops`` equal ``benchmarks/roofline.py``'s
  for every LM and cell.
* The counted flops of TinyLlama's smoke train step (batch 4 x 32) on a
  (1, 1) mesh against the reference's count on ``make_test_mesh((1, 1))``
  (``dryrun.lm_extrapolated_cost``, its count for LM train cells: XLA's
  ``cost_analysis`` of unrolled variants): the port counts the products
  and the flash kernel's kept query-key pairs, XLA counts every op
  (elementwise ops, reductions, the full unmasked score chunk), so the
  port's count is below the reference's and above ``FLOPS_FLOOR`` of it.
* A product sharded over every rank of the 16 x 16 mesh counts 1/256 of
  its global flops, a replicated one all of them, and its collectives
  their output bytes (in a child: a fake group of 256 ranks).
* ``python -m repro_torch.launch.dryrun --arch tinyllama-1.1b
  --both-meshes --json`` runs in a child (started as the module starts)
  and writes a record for each cell on each mesh, every non-skipped one
  "ok"; ``roofline.report`` reads it.
* ``fast_strategy_costs``' memoized plans change no count: TinyLlama's
  16 x 16 train cell, where DTensor's own pricing is fast enough, counts
  the same flops, op bytes and collective bytes with them and without
  (each in a child).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.configs import common as jcommon
from repro.launch.mesh import make_test_mesh as j_test_mesh
from repro_torch import configs
from repro_torch.configs import common
from repro_torch.launch import dryrun, roofline

ROOT = Path(__file__).resolve().parent.parent
ONLY_IN_REFERENCE = {("graphsage-reddit", "minibatch_lg"): 8}
FLOPS_FLOOR = 0.8      # measured: 7.30e7 against 8.04e7 (0.91)
SMOKE_SHAPE = dict(seq=32, batch=4)


def _reference_module(name):
    """Import a module of the reference that sets XLA_FLAGS at import
    (``repro.launch.dryrun``), restoring the environment after."""
    import importlib

    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


@pytest.fixture(scope="module", autouse=True)
def cli_child(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "tiny.json"
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "tinyllama-1.1b",
         "--both-meshes", "--json", str(out)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH="src"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield child, out
    if child.poll() is None:
        child.kill()
        child.communicate()


PLANS_CHILD = """
import json, sys
from repro_torch.launch import dryrun, mesh
dryrun._fake_group(256)
m = mesh.make_production_mesh(device_type="cpu")
if sys.argv[1] == "memoized":
    dryrun.fast_strategy_costs()
rec = dryrun.analyze_cell("tinyllama-1.1b", "train_4k", m, "16x16")
print(json.dumps({k: rec.get(k) for k in ("status", "error", "hlo_flops", "op_bytes",
                                          "collectives")}))
"""


@pytest.fixture(scope="module", autouse=True)
def plans_children():
    """TinyLlama's 16 x 16 train cell counted in two children, one with
    ``fast_strategy_costs``' memoized plans and one without (DTensor caches
    its strategies by op, so one process cannot run both), started as the
    module starts."""
    kids = {how: subprocess.Popen([sys.executable, "-c", PLANS_CHILD, how], cwd=ROOT,
                                  env=dict(os.environ, PYTHONPATH="src"),
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for how in ("plain", "memoized")}
    yield kids
    for child in kids.values():
        if child.poll() is None:
            child.kill()
            child.communicate()


def test_memoized_plans_change_no_count(plans_children):
    got = {}
    for how, child in plans_children.items():
        stdout, stderr = child.communicate(timeout=300)
        assert child.returncode == 0, stderr[-2000:]
        got[how] = json.loads(stdout.strip().splitlines()[-1])
    assert got["plain"]["status"] == "ok", got["plain"]["error"]
    assert got["memoized"] == got["plain"]


@pytest.mark.parametrize("arch", configs.list_archs())
def test_arg_bytes_are_the_references(arch):
    import jax

    ad, jad = configs.get_arch(arch), jconfigs.get_arch(arch)
    jmesh = j_test_mesh((1, 1))
    mesh = dryrun.MeshShape(("data", "model"), (1, 1))
    for cell in ad.cells():
        if cell.skip:
            continue
        low = jcommon.build_lowerable(jad, cell.shape, jmesh)
        want = sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                   for leaf in jax.tree.leaves(low.args))
        got = dryrun.arg_bytes(common.cell_program(ad, cell.shape, mesh))
        assert got + ONLY_IN_REFERENCE.get((arch, cell.shape), 0) == want, cell.shape


@pytest.mark.parametrize("arch", configs.list_archs("lm"))
def test_param_counts_and_model_flops_are_the_references(arch):
    jroof = _reference_module("benchmarks.roofline")
    ad = configs.get_arch(arch)
    assert roofline.lm_param_counts(ad.model_cfg) == jroof.lm_param_counts(
        jconfigs.get_arch(arch).model_cfg)
    for cell in ad.cells():
        assert roofline.model_flops(arch, cell.shape, cell.kind) == jroof.model_flops(
            arch, cell.shape, cell.kind)
    assert roofline.TOKENS == jroof.TOKENS


COUNT_CHILD = r"""
import json, sys
sys.path.insert(0, "src")
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
dryrun._fake_group(256)
mesh = make_production_mesh(device_type="cpu")
x = torch.empty((4096, 2048), device="meta")
w = torch.empty((2048, 5632), device="meta")
out = {}
for name, xp, wp in (("sharded", [Shard(0), Replicate()], [Replicate(), Shard(1)]),
                     ("replicated", [Replicate(), Replicate()], [Replicate(), Replicate()]),
                     ("gathered", [Shard(0), Replicate()], [Shard(0), Replicate()])):
    c = dryrun.StepCounter()
    xd, wd = distribute_tensor(x, mesh, xp), distribute_tensor(w, mesh, wp)
    with c:
        xd @ wd
    out[name] = {"flops": c.flops, "collectives": c.collectives}
print(json.dumps(out))
"""


def test_a_sharded_product_counts_its_share_per_rank():
    res = subprocess.run([sys.executable, "-c", COUNT_CHILD], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH="src"), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    full = 2 * 4096 * 2048 * 5632
    assert got["sharded"]["flops"] * 256 == full and got["sharded"]["collectives"] == {}
    assert got["replicated"]["flops"] == full
    # w sharded on its contracted dim over "data" while x's rows are too:
    # DTensor gathers one operand, whose bytes the count carries
    assert sum(got["gathered"]["collectives"].values()) > 0


def test_smoke_train_flops_sit_below_the_references_count(monkeypatch):
    import dataclasses

    jdry = _reference_module("repro.launch.dryrun")
    jad = jconfigs.get_arch("tinyllama-1.1b")
    jad = dataclasses.replace(jad, model_cfg=jad.smoke_cfg)
    monkeypatch.setitem(jcommon.LM_SHAPES, "train_4k", SMOKE_SHAPE)
    jmesh = j_test_mesh((1, 1))
    want, _, _ = jdry.lm_extrapolated_cost(jad, "train_4k", jmesh)

    from repro_torch.launch.mesh import make_test_mesh

    ad = configs.get_arch("tinyllama-1.1b")
    ad = dataclasses.replace(ad, model_cfg=ad.smoke_cfg)
    monkeypatch.setitem(common.LM_SHAPES, "train_4k", SMOKE_SHAPE)
    mesh = make_test_mesh((1, 1), device_type="cpu")
    prog = common.cell_program(ad, "train_4k", mesh)
    counter = dryrun.StepCounter()
    args = common.shard_args(prog, prog.args, mesh)
    with counter:
        prog.step(*args)
    assert FLOPS_FLOOR * want <= counter.flops < want, (counter.flops, want)
    assert counter.collectives == {}     # one rank: nothing to move


def test_the_cli_writes_a_record_for_every_cell_on_both_meshes(cli_child):
    child, out = cli_child
    stdout, stderr = child.communicate(timeout=600)
    assert child.returncode == 0, stderr[-2000:]
    recs = json.loads(out.read_text())
    cells = [c for c in configs.all_cells() if c.arch == "tinyllama-1.1b"]
    assert [(r["shape"], r["mesh"]) for r in recs] == [
        (c.shape, m) for c in cells for m in ("16x16", "2x16x16")]
    for r, c in zip(recs[::2], cells):
        assert r["status"] == ("skipped" if c.skip else "ok"), r.get("error")
    for r in recs:
        if r["status"] != "ok":
            continue
        assert r["cost_method"] == "direct" and r["hlo_flops"] > 0
        assert r["arg_bytes_per_device"] == r["arg_bytes_total"] // (
            256 if r["mesh"] == "16x16" else 512)
        assert r["bottleneck"] in ("compute", "memory", "collective")
        assert r["collective_bytes"] == sum(r["collectives"].values())
    lines = []
    rows = roofline.report(str(out), out=lines.append)
    assert len(rows) == sum(r["status"] == "ok" for r in recs) == len(lines) - 1 - 2
    assert all(0 < row["useful_ratio"] for row in rows)
