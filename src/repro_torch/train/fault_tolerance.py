"""Checkpoint / restart harness with failure injection, as
``repro/train/fault_tolerance.py``.

A worker that dies is re-executed and must resume bit-exactly from the last
atomic checkpoint (weights, optimizer, data position). ``run_with_restarts``
is that controller in miniature: it drives a step function, absorbs
``SimulatedFailure``s raised by a hook, restores the newest checkpoint and
goes on. Determinism comes from step-indexed data (``data/pipeline.py``),
the atomic checkpoint protocol (``train/checkpoint.py``) and kernels without
atomics (the attention backward sums each output in one block).
"""
from __future__ import annotations

from typing import Any, Callable

from . import checkpoint as ckpt_lib


class SimulatedFailure(RuntimeError):
    """Raised by failure-injection hooks to emulate a node loss."""


def run_with_restarts(*, total_steps: int, make_initial_state: Callable[[], Any],
                      step_fn: Callable[[int, Any], Any], ckpt_dir: str,
                      ckpt_every: int = 10, max_restarts: int = 10,
                      failure_hook: Callable[[int], None] | None = None) -> tuple[Any, dict]:
    """Drive ``step_fn(step, state) -> state`` to ``total_steps`` with a
    checkpoint every ``ckpt_every`` steps and at the end; ``failure_hook(step)``
    may raise SimulatedFailure at any step, and the run restores and goes on.
    Returns (state, {"restarts", "final_step"})."""
    template = make_initial_state()
    restored = ckpt_lib.restore_latest(ckpt_dir, template)
    step, state = (restored[0], restored[1]) if restored is not None else (0, template)
    restarts = 0
    while step < total_steps:
        try:
            if failure_hook is not None:
                failure_hook(step)
            state = step_fn(step, state)
            step += 1
            if step % ckpt_every == 0:
                ckpt_lib.save(ckpt_dir, step, state)
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError("restart budget exhausted") from None
            restored = ckpt_lib.restore_latest(ckpt_dir, template)
            step, state = ((restored[0], restored[1]) if restored is not None
                           else (0, make_initial_state()))
    ckpt_lib.save(ckpt_dir, step, state)
    return state, {"restarts": restarts, "final_step": step}
