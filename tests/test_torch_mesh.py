"""The port's meshes and sharding rules (``launch/mesh.py``,
``configs.common``, ``distributed.sharding``) on the CPU against live
calls into ``repro``.

* Placements, exactly: for all 10 archs on the 16 x 16, the 2 x 16 x 16 and
  the (1, 1) mesh, every cell's parameter, optimizer-state, batch and
  decode-cache leaf at full widths takes the spec of the reference's
  ``build_lowerable`` (its rules called on its ``jax.eval_shape`` trees
  with a stand-in mesh: an ``AbstractMesh`` that also carries
  ``devices.shape``, all that ``_axis_ok`` and ``fsdp_param_specs`` read).
  A stacked ``layers.X`` leaf's spec is each ``layers.{i}.X``'s with the
  stacked axis dropped; the reference's GNN parameters and optimizer state
  (in_shardings None) are replicated here; the minibatch cell's ``key``
  (2,) uint32 has no counterpart (the port's sampler draws from a
  generator).
* Shards, by mesh coordinate: Gemma3-12B (fsdp) and TinyLlama (tp) on the
  2 x 16 x 16 mesh; a child with 512 host devices prints
  ``NamedSharding(mesh, spec).devices_indices_map(shape)`` for a handful
  of leaves (multi-axis entries included), and the port's local shard at
  the same coordinate (``_compute_local_shape_and_global_offset`` of its
  placements) must be the same slice.
* The sharded step, run: four gloo ranks on a (2, 2) mesh
  (``tests/torch_mesh_worker.py``) take 2 train steps of TinyLlama's,
  Gemma3's and DeepSeek's smoke configs (tp, tp + fsdp, ``parallel_mode=
  "dp"``, ``mla_replicated_latents``) through ``cell_program``; the gathered
  losses and parameters must match the same steps on a (1, 1) mesh in this
  process: losses rtol 1e-5, parameters within 1e-5 of each one's max-abs.
  The (1, 1) step is the plain one-device step, bit for bit for TinyLlama
  and Gemma3 (DeepSeek within 1e-6 of max-abs: its MTP head's embedding
  gradient sums in another order through the vocab-parallel lookup), and
  matches the reference's jitted ``build_lowerable`` step on
  ``make_test_mesh((1, 1))`` from the same weights
  (``convert.lm_params_from_numpy``) and batches, held alike. In both
  parameter comparisons an element whose gradient sat below 1e-5 of its
  max-abs at some step is held within 2 x lr a step instead: AdamW's
  m / (sqrt(v) + eps) is ill-conditioned there (``test_torch_train_lm.py``
  finds the same), and the four ranks' and the reference's gradients sum in
  other orders.
* The launcher on the mesh: the same four ranks run ``launch.train.
  train_lm`` (TinyLlama's smoke config, 2 steps), which draws the weights
  a parameter at a time keeping each rank's shards; its losses and
  gathered parameters are held, as above, to the plain steps in this
  process from the same seed. ``train_mesh`` takes the (1, 1) mesh with
  ``--smoke`` and on one rank, and refuses ``--multi-pod`` on one rank by
  its rank count.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import AbstractMesh, NamedSharding

import torch_mesh_worker as worker
from repro import configs as jconfigs
from repro.configs import common as jcommon
from repro.launch.mesh import make_test_mesh as j_test_mesh
from repro.models import transformer as JT
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.configs import common
from repro_torch.data.synthetic import lm_batch_for_step
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import leaves, make_optimizer
from repro_torch.train.train_loop import make_train_step, trainable
from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
STEP_REL = 1e-5
SMALL_GRAD_REL = 1e-5     # a gradient this far below its max-abs: AdamW ill-conditioned
BIT_IDENTICAL = {"tinyllama", "gemma3"}   # (1, 1) == plain, bit for bit
PLAIN_REL = 1e-6          # DeepSeek: the MTP head's second embedding lookup sums its
#                           gradient through the vocab-parallel lookup in another order
SPAWN_TIMEOUT_S = 120
ONLY_IN_REFERENCE = {("graphsage-reddit", "minibatch_lg"): {"2.key"}}


class StandIn(AbstractMesh):
    """The reference's rules read ``axis_names`` and ``devices.shape``."""

    @property
    def devices(self):
        return np.empty(self.axis_sizes, dtype=object)


def _port_mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(mesh_dim_names=axes, shape=shape)


def _key(path) -> str:
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return ".".join(parts)


def _pad(spec, nd) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (nd - len(spec))


def _reference_specs(ad, shape, mesh) -> dict:
    """leaf path -> (spec padded to its rank) of the reference's lowerable;
    None for an unspecified sharding."""
    low = jcommon.build_lowerable(ad, shape, mesh)
    out = {}
    for i, (args, shard) in enumerate(zip(low.args, low.in_shardings)):
        flat_a = jax.tree_util.tree_flatten_with_path(args)[0]
        if shard is None:
            for path, a in flat_a:
                out[_key(((SimpleNamespace(idx=i),) + tuple(path)))] = None
            continue
        if isinstance(shard, NamedSharding):
            shard = jax.tree.map(lambda _: shard, args)
        flat_s = jax.tree_util.tree_flatten_with_path(
            shard, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
        specs = {_key(p): s.spec for p, s in flat_s}
        for path, a in flat_a:
            out[_key(((SimpleNamespace(idx=i),) + tuple(path)))] = _pad(
                specs[_key(path)], len(a.shape))
    return out


def _port_specs(ad, shape, mesh) -> dict:
    """The same paths for the port's program: parameters by the reference's
    leaf (a stacked leaf once, from layers.0 with the axis put back: every
    layer's spec checked equal), AdamW's m / v likewise, Adafactor's state
    by its own leaf keys."""
    prog = common.cell_program(ad, shape, mesh)
    out = {}
    for i, (a, s) in enumerate(zip(prog.args, prog.specs)):
        if isinstance(a, torch.nn.Module):
            _params_into(out, f"{i}", {n: tuple(p.shape) for n, p in a.named_parameters()}, s,
                         ad.family == "lm")
        elif isinstance(a, dict) and "step" in a:   # optimizer state
            out[f"{i}.step"] = _pad(s["step"], 0)
            for part in ("m", "v"):
                if part in a:
                    _params_into(out, f"{i}.{part}",
                                 {n: tuple(t.shape) for n, t in a[part].items()}, s[part],
                                 ad.family == "lm")
            for part in ("vr", "vc"):
                if part in a:
                    out.update({f"{i}.{part}.{k}": _pad(s[part][k], a[part][k].dim())
                                for k in a[part]})
        elif isinstance(a, torch.Tensor):
            out[f"{i}"] = _pad(s, a.dim())
        else:
            flat = _flatten(a, f"{i}")
            sflat = _flatten(s, f"{i}", spec=True)
            out.update({k: _pad(sflat[k], t.dim()) for k, t in flat.items()})
    return out


def _flatten(tree, pre, spec=False):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {pre: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{pre}.{k}", spec))
    return out


def _params_into(out, pre, shapes, specs, lm=True):
    groups = leaves(shapes) if lm else {n: [n] for n in shapes}
    for key, names in groups.items():
        per = {specs[n] for n in names}
        assert len(per) == 1, f"{key}: layers differ {per}"
        spec = per.pop()
        stacked = key != names[0]
        nd = len(shapes[names[0]])
        out[f"{pre}.{key}"] = (None,) + _pad(spec, nd) if stacked else _pad(spec, nd)


@pytest.fixture(scope="module")
def reference_specs():
    cache = {}

    def get(arch, mesh_name):
        if (arch, mesh_name) not in cache:
            shape, axes = MESHES[mesh_name]
            jm = StandIn(shape, axes)
            jad = jconfigs.get_arch(arch)
            cache[arch, mesh_name] = {c.shape: _reference_specs(jad, c.shape, jm)
                                      for c in jad.cells() if not c.skip}
        return cache[arch, mesh_name]

    return get


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.list_archs())
def test_every_leaf_takes_the_references_spec(reference_specs, arch, mesh_name):
    ad = configs.get_arch(arch)
    want = reference_specs(arch, mesh_name)
    for cell in ad.cells():
        if cell.skip:
            continue
        got = _port_specs(ad, cell.shape, _port_mesh(mesh_name))
        ref = dict(want[cell.shape])
        for k in ONLY_IN_REFERENCE.get((arch, cell.shape), ()):
            ref.pop(k)
        assert got.keys() == ref.keys(), (cell.shape, sorted(got.keys() ^ ref.keys())[:8])
        for k, r in ref.items():
            r = _pad((), len(got[k])) if r is None else r
            assert got[k] == r, f"{arch}:{cell.shape} {k}: {got[k]} != {r}"


def test_placements_follow_the_spec_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    m = _port_mesh("2x16x16")
    assert sharding.placements(m, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.placements(m, (None,)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements(m, (("data", "pod"), None))
    with pytest.raises(ValueError, match="shards two dims"):
        sharding.placements(m, ("model", "model"))


def test_a_mesh_of_the_wrong_size_raises():
    pmesh.make_test_mesh((1, 1), device_type="cpu")   # the one-rank group of this process
    with pytest.raises(RuntimeError, match="needs 256 ranks; the process group has 1"):
        pmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        pmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    mesh = pmesh.make_test_mesh((1, 1), device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and pmesh.data_axes(mesh) == ("data",)


# -- shards by mesh coordinate -----------------------------------------------------

SAMPLED = {"gemma3-12b": ["layers.attn.wq", "layers.attn.wo", "layers.mlp.w_down", "embed",
                          "lm_head", "batch.tokens"],
           "tinyllama-1.1b": ["layers.attn.wk", "layers.mlp.w_up", "embed", "batch.tokens",
                              "fsdp.layers.mlp.w_gate", "fsdp.embed"]}
COORDS = [(0, 0, 0), (0, 0, 5), (0, 7, 0), (1, 0, 0), (1, 3, 9), (1, 15, 15)]

CHILD = r"""
import json, sys
import numpy as np, jax
sys.path.insert(0, "src")
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.configs import common
from repro.launch.mesh import make_production_mesh
from repro.models import transformer as tf
sampled, coords = json.loads(sys.argv[1]), [tuple(c) for c in json.loads(sys.argv[2])]
mesh = make_production_mesh(multi_pod=True)
out = {}
for arch, names in sampled.items():
    ad = configs.get_arch(arch)
    params = jax.eval_shape(lambda k: tf.init_params(k, ad.model_cfg), jax.random.PRNGKey(0))
    flat = {".".join(str(getattr(k, "key", k)) for k in p): l
            for p, l in jax.tree_util.tree_flatten_with_path(params)[0]}
    specs = common.lm_param_specs(params, mesh, ad.fsdp)
    fspecs = common.fsdp_param_specs(params, mesh)
    sflat = {".".join(str(getattr(k, "key", k)) for k in p): s for p, s in
             jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]}
    fflat = {".".join(str(getattr(k, "key", k)) for k in p): s for p, s in
             jax.tree_util.tree_flatten_with_path(fspecs, is_leaf=lambda x: isinstance(x, P))[0]}
    for name in names:
        if name == "batch.tokens":
            shape, spec = (256, 4096), P(common.dp_axes(mesh), None)
        elif name.startswith("fsdp."):
            shape, spec = flat[name[5:]].shape, fflat[name[5:]]
        else:
            shape, spec = flat[name].shape, sflat[name]
        m = NamedSharding(mesh, spec).devices_indices_map(shape)
        got = {}
        for d, idx in m.items():
            c = tuple(int(x) for x in np.argwhere(mesh.devices == d)[0])
            if c in coords:
                got[str(list(c))] = [[s.start or 0, shape[i] if s.stop is None else s.stop]
                                     for i, s in enumerate(idx)]
        out[f"{arch}/{name}"] = {"shape": list(shape), "spec": [list(e) if isinstance(e, tuple)
                                 else e for e in spec], "slices": got}
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def shards_child():
    """The 512-device child, started as the module starts."""
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    child = subprocess.Popen([sys.executable, "-c", CHILD, json.dumps(SAMPLED),
                              json.dumps(COORDS)], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield child
    if child.poll() is None:
        child.kill()
        child.communicate()


@pytest.fixture(scope="module")
def reference_shards(shards_child):
    out, err = shards_child.communicate(timeout=300)
    assert shards_child.returncode == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1])


def _port_leaf(ad, name, mesh):
    """(per-layer shape, spec) of a sampled leaf on the port's side."""
    if name == "batch.tokens":
        return (256, 4096), common.cell_program(ad, "train_4k", mesh).specs[2]["tokens"]
    fsdp = name.startswith("fsdp.")
    ad = dataclasses.replace(ad, parallel_mode="fsdp") if fsdp else ad
    name = name[5:] if fsdp else name
    model = T.Transformer(ad.model_cfg, "meta")
    p_specs, _, _ = common.lm_specs(ad, model, mesh)
    port = name.replace("layers.", "layers.3.", 1) if name.startswith("layers.") else name
    return tuple(dict(model.named_parameters())[port].shape), p_specs[port]


@pytest.mark.parametrize("arch", list(SAMPLED))
def test_local_shards_are_the_references_by_mesh_coordinate(reference_shards, arch):
    mesh = _port_mesh("2x16x16")
    ad = configs.get_arch(arch)
    for name in SAMPLED[arch]:
        ref = reference_shards[f"{arch}/{name}"]
        shape, spec = _port_leaf(ad, name, mesh)
        stacked = len(ref["shape"]) == len(shape) + 1
        pl = sharding.placements(mesh, spec)
        assert any(p.is_shard() for p in pl), f"{name}: replicated"
        for coord in COORDS:
            lshape, off = _compute_local_shape_and_global_offset(shape, (2, 16, 16),
                                                                 list(coord), pl)
            got = [[o, o + n] for o, n in zip(off, lshape)]
            want = ref["slices"][str(list(coord))]
            assert got == (want[1:] if stacked else want), (name, coord, got, want)


# -- the sharded step --------------------------------------------------------------


def _inputs(name):
    arch, mode, extra = worker.CASES[name]
    jad = jconfigs.get_arch(arch)
    jad = dataclasses.replace(jad, model_cfg=jad.smoke_cfg, parallel_mode=mode, extra=extra)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jad.model_cfg))
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(worker.STEPS):
        toks = rng.integers(0, jad.model_cfg.vocab, (worker.B, worker.S)).astype(np.int32)
        labels = np.concatenate([toks[:, 1:], np.full((worker.B, 1), -100, np.int32)], 1)
        labels[0, 5] = -100
        batches.append({"tokens": toks, "labels": labels})
    return jad, tree, batches


_INPUTS = {}


def _all_inputs():
    if not _INPUTS:
        _INPUTS.update({name: _inputs(name) for name in worker.CASES})
    return _INPUTS


@pytest.fixture(scope="module")
def inputs():
    return _all_inputs()


@pytest.fixture(scope="module", autouse=True)
def four_rank_procs(tmp_path_factory):
    """Four gloo ranks started as the module starts, so they run beside the
    placement tests; :func:`four_ranks` collects them."""
    out = tmp_path_factory.mktemp("mesh_ranks")
    payload = {n: {"tree": tree, "batches": batches}
               for n, (_, tree, batches) in _all_inputs().items()}
    ctx = mp.get_context("spawn")
    before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [ctx.Process(target=worker.run_rank,
                             args=(r, 4, str(out / "store"), payload, str(out)))
                 for r in range(4)]
        for p in procs:
            p.start()
    finally:
        if before is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = before
    yield procs, out, time.monotonic() + SPAWN_TIMEOUT_S
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)


@pytest.fixture(scope="module")
def four_ranks(four_rank_procs):
    procs, out, deadline = four_rank_procs
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join(10)
    assert not hung, f"ranks {hung} still running after {SPAWN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * 4
    got = dict(np.load(out / "rank0.npz"))
    return {n: {k.split("/", 1)[1]: v for k, v in got.items() if k.startswith(n + "/")}
            for n in [*worker.CASES, "train_lm"]}


@pytest.fixture(scope="module")
def one_process(inputs):
    mesh = pmesh.make_test_mesh((1, 1), device_type="cpu")
    return {n: worker.run_case(mesh, n, tree, batches)
            for n, (_, tree, batches) in inputs.items()}


def _close_by_max(got, want, rel, what):
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol, what


@pytest.fixture(scope="module")
def plain(inputs):
    return {n: _plain_steps(n, tree, batches) for n, (_, tree, batches) in inputs.items()}


def _held(got, want, small, lr, what):
    """Each parameter within STEP_REL of its max-abs, but where its
    gradient sat near 0 (within 2 x lr a step)."""
    for n, near0 in small.items():
        diff = np.abs(got[f"p:{n}"] - want[n])
        near0 = near0.numpy()
        tol = STEP_REL * float(np.abs(want[n]).max())
        assert diff[~near0].max(initial=0.0) <= tol, f"{what} {n}"
        assert diff[near0].max(initial=0.0) <= 2 * lr * worker.STEPS, f"{what} {n} (grad ~ 0)"


LR = {"adamw": 3e-4, "adafactor": 1e-3}


@pytest.mark.parametrize("name", list(worker.CASES))
def test_four_gloo_ranks_match_one_process(four_ranks, one_process, plain, name):
    got, want = four_ranks[name], one_process[name]
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=STEP_REL)
    lr = LR[configs.get_arch(worker.CASES[name][0]).optimizer]
    _held(got, {k[2:]: v for k, v in want.items() if k.startswith("p:")}, plain[name][1], lr,
          f"{name} 4 ranks")


def _reference_steps(jad, tree, batches):
    old = jcommon.LM_SHAPES["train_4k"]
    jcommon.LM_SHAPES["train_4k"] = dict(seq=worker.S, batch=worker.B)
    try:
        mesh = j_test_mesh((1, 1))
        low = jcommon.build_lowerable(jad, "train_4k", mesh)
    finally:
        jcommon.LM_SHAPES["train_4k"] = old
    params = jax.tree.map(jnp.asarray, tree)
    opt = jopt.make_optimizer(jad.optimizer)[0](params)
    losses = []
    with mesh:
        step = jax.jit(low.fn, in_shardings=low.in_shardings)
        for b in batches:
            params, opt, loss = step(params, opt, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(loss))
    return np.array(losses), params


def _plain_steps(name, tree, batches):
    """The plain one-device step (no mesh) from the same weights, with the
    elements whose gradient sat near 0 at some step."""
    from repro_torch.models import convert

    arch, mode, extra = worker.CASES[name]
    ad = configs.get_arch(arch)
    model = convert.lm_params_from_numpy(tree, ad.smoke_cfg, "cpu")
    model, small, _ = _spied_steps(ad, model, [{k: torch.from_numpy(v) for k, v in b.items()}
                                               for b in batches])
    return model, small


def _spied_steps(ad, model, batches):
    """-> (model, {name: elements whose gradient sat near 0 at some step},
    losses) after the plain one-device steps on ``batches``."""
    init, update = make_optimizer(ad.optimizer)
    small = {}

    def spying(grads, st, params):
        for n, g in grads.items():
            near0 = g.abs() <= SMALL_GRAD_REL * g.abs().max()
            small[n] = small[n] | near0 if n in small else near0
        return update(grads, st, params)

    step = make_train_step(T.loss_fn, spying)
    state = init(trainable(model))
    losses = []
    for b in batches:
        _, state, metrics = step(model, state, b)
        losses.append(float(metrics["loss"]))
    return model, small, np.array(losses)


def test_train_lm_on_four_gloo_ranks_is_the_plain_steps(four_ranks):
    """``launch.train.train_lm`` on the (2, 2) mesh (weights drawn a
    parameter at a time, each rank keeping its shards; the optimizer state
    allocated shard by shard) against the plain steps here from the same
    seed and batches."""
    got = four_ranks["train_lm"]
    args = train.parser().parse_args(worker.TRAIN_LM_ARGV)
    ad = configs.get_arch(args.arch)
    cfg = ad.smoke_cfg
    batches = [lm_batch_for_step(args.seed, s, args.batch, args.seq, cfg.vocab, "cpu")
               for s in range(args.steps)]
    model, small, losses = _spied_steps(ad, T.init_params(cfg, args.seed, "cpu"), batches)
    np.testing.assert_allclose(got["loss"], losses, rtol=STEP_REL)
    _held(got, {n: p.detach().numpy() for n, p in model.named_parameters()}, small,
          LR[ad.optimizer], "train_lm on 4 ranks")


@pytest.mark.parametrize("smoke", [[], ["--smoke"]])
def test_train_mesh_takes_the_test_mesh_with_smoke_and_refuses_by_rank_count(smoke):
    """``--smoke`` trains on the (1, 1) mesh, as the reference's, and so
    does a one-rank world without it; ``--multi-pod`` on one rank is
    refused, with or without ``--smoke``, naming the rank count it needs."""
    argv = ["--arch", "tinyllama-1.1b", "--device", "cpu", *smoke]
    mesh = train.train_mesh(train.parser().parse_args(argv))
    assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    with pytest.raises(RuntimeError, match="--multi-pod needs 512 ranks; the process group has 1"):
        train.train_mesh(train.parser().parse_args(argv + ["--multi-pod"]))


@pytest.mark.parametrize("name", list(worker.CASES))
def test_one_process_step_is_the_plain_step_and_the_references(inputs, one_process, plain,
                                                               name):
    from repro_torch.models.convert import _flatten as flatten

    jad, tree, batches = inputs[name]
    got = one_process[name]
    model, small = plain[name]
    for n, p in model.named_parameters():
        if name in BIT_IDENTICAL:
            np.testing.assert_array_equal(got[f"p:{n}"], p.detach().numpy(), err_msg=n)
        else:
            _close_by_max(got[f"p:{n}"], p.detach().numpy(), PLAIN_REL, f"{name} {n}")
    jl, jp = _reference_steps(jad, tree, batches)
    np.testing.assert_allclose(got["loss"], jl, rtol=STEP_REL)
    n_scan = jad.model_cfg.n_layers - jad.model_cfg.n_dense_prefix
    flat = {}
    for k, v in flatten(jax.tree.map(np.asarray, jp)).items():
        if k.startswith("layers."):
            flat.update({f"layers.{i}.{k[7:]}": v[i] for i in range(n_scan)})
        else:
            flat[k] = v
    _held(got, flat, small, LR[jad.optimizer], f"{name} vs the reference")
