"""The benchmark's data: the paper's manifold stand-ins, drawn from a seed.

A plain-torch copy of the manifold law the port's ``data/synthetic.py``
uses (paper Tab. I): latent points uniform in [0, 1)^latent, lifted by a
random two-layer tanh map into R^d, plus isotropic noise of 0.01. Here the
lift is drawn once per base, and fresh query batches are drawn through the
same lift, so queries lie on the base's manifold.

The points of a base are one fixed draw per configuration (its
``data_seed``), as a corpus is fixed; a run's seed puts them in an order of
its own and draws the queries. So every seed serves the same set of points
in another order, with other queries. Every draw comes from a
``torch.Generator`` on the target device, seeded from ``(seed, stream,
index)`` by :func:`substream`: the same seed gives the same base and the
same query batches on any run, and a batch can be drawn again after the
window without having been kept. Row blocks keep the peak memory of a draw
near one block of noise.
"""
from __future__ import annotations

import hashlib
import math
from typing import NamedTuple

import torch

NOISE = 0.01
BLOCK_ROWS = 1 << 18


def substream(seed: int, stream: str, index: int = 0) -> int:
    """A 62-bit generator seed for (seed, stream, index): sha256 of the
    three, so streams never share draws whatever the seed's size."""
    h = hashlib.sha256(f"{int(seed)}:{stream}:{int(index)}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 62) - 1)


class Lift(NamedTuple):
    w1: torch.Tensor   # (latent, 2 latent)
    w2: torch.Tensor   # (2 latent, d)


def draw_lift(gen: torch.Generator, d: int, latent: int) -> Lift:
    """The random lift's two weight matrices, scaled as the paper's stand-ins."""
    dev = gen.device
    w1 = torch.randn((latent, 2 * latent), generator=gen, device=dev) / math.sqrt(latent)
    w2 = torch.randn((2 * latent, d), generator=gen, device=dev) / math.sqrt(2 * latent)
    return Lift(w1, w2)


def draw_points(gen: torch.Generator, lift: Lift, n: int) -> torch.Tensor:
    """n points (n, d) float32 on the lift's manifold: tanh(z w1) w2 + 0.01
    eps, drawn in blocks of BLOCK_ROWS rows (z, then eps, per block)."""
    latent, d = lift.w1.shape[0], lift.w2.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=gen.device)
    for lo in range(0, n, BLOCK_ROWS):
        m = min(BLOCK_ROWS, n - lo)
        z = torch.rand((m, latent), generator=gen, device=gen.device)
        eps = torch.randn((m, d), generator=gen, device=gen.device)
        torch.matmul(torch.tanh(z @ lift.w1), lift.w2, out=out[lo:lo + m])
        out[lo:lo + m].add_(eps, alpha=NOISE)
    return out


class World(NamedTuple):
    base: torch.Tensor
    lift: Lift
    seed: int


def make_world(seed: int, n: int, d: int, latent: int, data_seed: int, device) -> World:
    """The base of a run: the lift and n points of ``(data_seed, "base")``,
    in the order of ``(seed, "order")``."""
    gen = torch.Generator(device=device).manual_seed(substream(data_seed, "base"))
    lift = draw_lift(gen, d, latent)
    points = draw_points(gen, lift, n)
    order = torch.randperm(n, generator=torch.Generator(device=device).manual_seed(
        substream(seed, "order")), device=device)
    return World(points[order], lift, seed)


def query_batch(world: World, index: int, rows: int) -> torch.Tensor:
    """Query batch ``index``: ``rows`` fresh points through the base's lift,
    from ``(seed, "queries", index)``."""
    gen = torch.Generator(device=world.base.device).manual_seed(
        substream(world.seed, "queries", index))
    return draw_points(gen, world.lift, rows)
