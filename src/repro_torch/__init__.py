"""PyTorch/CUDA port of the graph-ANN engine in ``repro``.

The layout mirrors ``repro``: ``kernels/`` (hand-written Hopper kernels, their
plain-PyTorch versions and the device dispatch), ``core/`` (graph build, beam
search, brute force) and ``launch/`` (the serving entry point). The package
imports torch, numpy and the standard library only.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
