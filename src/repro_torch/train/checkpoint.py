"""Step-indexed, atomic checkpoints, the reference's protocol
(``repro/train/checkpoint.py``).

Layout: ``<dir>/step_<N:010d>/arrays.npz`` + ``meta.json``, written into a
``.tmp_`` directory and renamed (atomic on POSIX), so a crash mid-write
never leaves a partial step; the newest 3 steps are kept. ``latest_step``
counts a step only if its ``meta.json`` exists.

A state is any tree of dicts, lists and tuples with tensors at the leaves.
Its keys are the leaves' paths joined by "/", the dict keys as they are,
so a model's leaves keep their state-dict names (``params/layers.0.attn.wq``,
``opt/m/layers.0.attn.wq``, ``opt/step``). Arrays are saved from the host;
bf16 has no numpy dtype and goes through an int16 view bit for bit (as
``models/convert.py`` carries it), its dtype named in ``meta.json``.
``restore`` places each array on the device and in the dtype of the
``like`` leaf it replaces, and refuses a missing key or another shape.
The reference's ``reshard`` (placing a tree on a JAX mesh) has no
counterpart: the port trains on one device.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

KEEP = 3


def _items(tree):
    if isinstance(tree, dict):
        return tree.items()
    if isinstance(tree, (list, tuple)):
        return enumerate(tree)
    return None


def flatten(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """{path: leaf} with paths joined by "/"."""
    items = _items(tree)
    if items is None:
        return {prefix[:-1]: tree}
    out = {}
    for key, sub in items:
        out.update(flatten(sub, f"{prefix}{key}/"))
    return out


def _rebuild(like: Any, flat: dict, prefix: str = "") -> Any:
    items = _items(like)
    if items is None:
        return flat[prefix[:-1]]
    built = {key: _rebuild(sub, flat, f"{prefix}{key}/") for key, sub in items}
    if isinstance(like, dict):
        return built
    return type(like)(built[i] for i in range(len(like)))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def save(ckpt_dir: str, step: int, state: Any, extra: dict | None = None) -> str:
    """Atomically write ``state`` and its metadata for ``step``; keep the
    newest ``KEEP`` steps. Returns the step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        flat = flatten(state)
        np.savez(os.path.join(tmp, "arrays.npz"), **{k: _to_numpy(v) for k, v in flat.items()})
        meta = {"step": step, "dtypes": {k: str(v.dtype) for k, v in flat.items()},
                "extra": extra or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    steps = sorted(p for p in os.listdir(ckpt_dir) if p.startswith("step_"))
    for old in steps[:-KEEP]:
        shutil.rmtree(os.path.join(ckpt_dir, old), ignore_errors=True)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """The newest step whose ``meta.json`` was written, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(p.split("_")[1]) for p in os.listdir(ckpt_dir)
             if p.startswith("step_") and os.path.exists(os.path.join(ckpt_dir, p, "meta.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any) -> tuple[Any, dict]:
    """The state saved at ``step`` in the structure of ``like`` (a tree of
    tensors), each leaf on its ``like`` leaf's device and in its dtype;
    raises ValueError on a key that is missing or a shape that differs."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for key, leaf in flatten(like).items():
            if key not in z.files:
                raise ValueError(f"checkpoint step {step} has no array {key!r}")
            arr = z[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)}, want "
                                 f"{tuple(leaf.shape)}")
            t = torch.from_numpy(arr)
            if meta["dtypes"].get(key) == str(torch.bfloat16):
                t = t.view(torch.bfloat16)
            out[key] = t.to(device=leaf.device, dtype=leaf.dtype)
    return _rebuild(like, out), meta["extra"]


def restore_latest(ckpt_dir: str, like: Any):
    """(step, state, extra) of the newest complete step, or None."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    state, extra = restore(ckpt_dir, step, like)
    return step, state, extra
