"""Process groups and device meshes for the port: the counterpart of the
reference's ``launch/mesh.py``. Functions, not module constants: importing
this module starts nothing.

* ``make_flat_group``: the ANN shard-and-merge layout (the reference's
  ``make_flat_mesh``), every rank on one axis.
* ``make_production_mesh``: the LM meshes, 16 x 16 as ``("data",
  "model")`` (256 ranks) or 2 x 16 x 16 as ``("pod", "data", "model")``
  (512 ranks), each a ``torch.distributed.device_mesh.DeviceMesh``.
* ``make_test_mesh``: the same axis names at a small shape ((1, 1) by
  default) for one process or a few.
* ``data_axes``: the axes that carry the batch dimension.

A mesh is laid over the default group that exists: a real one of exactly
``prod(shape)`` ranks, or a ``fake`` one for counting (``launch/dryrun.py``
initialises a fake group of 256 or 512 ranks in one process). A group of
another size raises: a mesh is never shrunk or grown quietly. Where no group
exists, ``make_test_mesh`` of one rank initialises one in this process over
an in-memory store, as ``make_flat_group`` does: ``nccl`` for ``cuda``,
``gloo`` for the CPU.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .._device import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


class FlatGroup(NamedTuple):
    """The flat shard group: every rank on one axis, rank r owning shard r."""

    group: dist.ProcessGroup
    rank: int
    size: int


def _init_one_rank(dev) -> None:
    """A one-rank default group over an in-memory store (no address, no
    network): ``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_flat_group(device="cuda") -> FlatGroup:
    """All ranks on one axis, the ANN shard-and-merge layout: the default
    ``torch.distributed`` group with this process's rank and the world
    size. Where no group is set up yet, a one-rank group is initialized in
    this process over an in-memory store (no address, no network): ``nccl``
    for a CUDA ``device``, ``gloo`` for the CPU. A multi-rank group is the
    launcher's to set up (``torchrun`` and ``init_process_group``) before
    this call. No fallback: a backend that fails to initialize raises."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        _init_one_rank(dev)
    group = dist.group.WORLD
    return FlatGroup(group, dist.get_rank(group), dist.get_world_size(group))


def _mesh(shape, axes, device_type: str) -> DeviceMesh:
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    need = math.prod(shape)
    if not dist.is_initialized():
        if need != 1:
            raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs a process group "
                               f"of {need} ranks; none is initialized")
        _init_one_rank(resolve_device(device_type))
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs {need} ranks; "
                           f"the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16 x 16 ``("data", "model")`` over 256 ranks, or 2 x 16 x 16
    ``("pod", "data", "model")`` over 512 (``multi_pod``): the reference's
    production meshes. The default group must have exactly that many
    ranks."""
    shape, axes = PRODUCTION[multi_pod]
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape=(1, 1), axes=("data", "model"), device_type: str = "cuda") -> DeviceMesh:
    """A small mesh with the production axis names, for tests and one
    card: (1, 1) by default, whose placements are the production specs on
    one rank."""
    return _mesh(shape, axes, device_type)


def data_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """Axes carrying the batch dimension ('pod' + 'data' when present)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
