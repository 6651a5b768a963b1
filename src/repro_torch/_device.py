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
