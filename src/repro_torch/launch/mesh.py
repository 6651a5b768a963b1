"""Process groups for the port: the counterpart of the reference's
``launch/mesh.py``. Functions, not module constants: importing this module
starts nothing.

Only the ANN shard-and-merge layout is here (``make_flat_group``, the
reference's ``make_flat_mesh``). The LM meshes (``make_production_mesh``,
``make_test_mesh``, ``data_axes``) come with the LM training and recsys
workloads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch.distributed as dist

from .._device import resolve_device


class FlatGroup(NamedTuple):
    """The flat shard group: every rank on one axis, rank r owning shard r."""

    group: dist.ProcessGroup
    rank: int
    size: int


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
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    group = dist.group.WORLD
    return FlatGroup(group, dist.get_rank(group), dist.get_world_size(group))
