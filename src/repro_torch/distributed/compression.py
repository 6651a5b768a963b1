"""Gradient compression for the data-parallel all-reduce, as
``repro/distributed/compression.py``, on ``torch.distributed``.

* **int8 quantization** with one shared per-tensor scale and stochastic
  rounding: the wire carries int8 values and one fp32 scale; the sum is
  taken in int32 (512 ranks x 127 is far below 2**31).
* **top-k sparsification with error feedback** (Deep Gradient Compression):
  each rank sends its k largest-magnitude entries, and what it did not send
  is added to its next gradient.

The reference writes the collectives inside ``shard_map`` over a mesh's
data axis; here they are ``all_reduce`` calls on a process group (``None``
is the default group), or on a ``DeviceMesh``'s first data axis. Stochastic rounding's noise, uniform in [-0.5, 0.5),
is an input of the functions that use it, drawn by :func:`int8_noise` from a
``torch.Generator``: the draws differ from ``jax.random``'s, so the tests
feed both packages the same noise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..launch.mesh import data_axes


def int8_noise(generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """Uniform noise in [-0.5, 0.5) of ``like``'s shape, fp32, drawn on the
    generator's device and moved to ``like``'s."""
    u = torch.rand(like.shape, generator=generator, device=generator.device)
    return (u - 0.5).to(like.device)


# -- int8 stochastic quantization ------------------------------------------------


def _round_int8(x: torch.Tensor, scale: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale + noise), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor, noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (q int8, scale): scale = max(max|x|, 1e-12) / 127, q =
    clip(round(x / scale + noise), -127, 127)."""
    scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
    return _round_int8(x, scale, noise), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_int8(x: torch.Tensor, noise: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over the group's ranks with an int8 wire: one all-reduce
    (max) agrees on the scale, each rank quantizes with its noise, the int8
    values are summed in int32, and the sum is dequantized and divided by
    the world size."""
    gmax = x.abs().max().float().reshape(1)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(gmax[0], 1e-12) / 127.0
    total = _round_int8(x, scale, noise).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.float() * scale / float(dist.get_world_size(group))


# -- top-k sparsification with error feedback --------------------------------------


class EFState(NamedTuple):
    residual: torch.Tensor  # same shape as the gradient, fp32


def ef_init(x: torch.Tensor) -> EFState:
    return EFState(residual=torch.zeros(x.shape, dtype=torch.float32, device=x.device))


def topk_compress(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k entries of largest magnitude of x flattened, largest first ->
    (values, int32 indices)."""
    flat = x.reshape(-1)
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx.to(torch.int32)


def topk_decompress(values: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    return torch.zeros((size,), dtype=values.dtype, device=values.device).index_add_(
        0, idx.long(), values)


def compressed_psum_topk(x: torch.Tensor, ef: EFState, k: int,
                         group=None) -> tuple[torch.Tensor, EFState]:
    """Each rank contributes the k largest entries of (x + residual); the
    sparse contributions are averaged over the group and what was not sent
    becomes the next residual."""
    corrected = x.float() + ef.residual
    vals, idx = topk_compress(corrected, k)
    dense = topk_decompress(vals, idx, corrected.numel()).reshape(x.shape)
    residual = corrected - dense
    total = dense.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total / float(dist.get_world_size(group)), EFState(residual=residual)


# -- dicts of gradients --------------------------------------------------------------


def make_compressed_allreduce(group=None, scheme: str = "int8", k_frac: float = 0.01):
    """-> fn(grads, generator) -> grads averaged over the group, each in its
    own dtype. ``group`` is a process group (``None``: the default one) or
    a ``DeviceMesh``, whose first data axis's group is taken (the
    reference's rule: ``data_axes(mesh)[0]``, "pod" on the 2 x 16 x 16
    mesh). ``scheme="int8"`` goes through :func:`compressed_psum_int8` with
    noise drawn leaf by leaf (in the dict's order) from the generator, any
    other scheme a plain fp32 mean. As in the reference, the top-k scheme
    (whose error feedback is state the caller keeps) is not wired here:
    call :func:`compressed_psum_topk`; ``k_frac`` keeps its signature."""
    if isinstance(group, DeviceMesh):
        group = group.get_group(data_axes(group)[0])

    def allreduce(grads: dict, generator: torch.Generator) -> dict:
        out = {}
        for name, g in grads.items():
            if scheme == "int8":
                red = compressed_psum_int8(g, int8_noise(generator, g), group)
            else:
                red = g.float().clone()
                dist.all_reduce(red, op=dist.ReduceOp.SUM, group=group)
                red = red / float(dist.get_world_size(group))
            out[name] = red.to(g.dtype)
        return out

    return allreduce
