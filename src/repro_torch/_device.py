"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU by name. A
missing GPU is an error, never a quiet switch to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``None``/"cuda"/"cuda:N" -> that CUDA device (raises when no GPU is
    visible); "cpu" -> the CPU. Anything else raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev


def model_device(device: str | torch.device | None = "cuda") -> torch.device:
    """:func:`resolve_device`, or ``meta``: a model or cache built on the
    meta device holds shapes and dtypes only (the dry run's arguments,
    ``configs.common.cell_program``); no entry point takes it."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)
