"""Named spans of the program's phases, on the profiler's clock.

``with span("beam.step"): ...`` enters
``torch.profiler.record_function("repro_torch.beam.step")`` while a torch
profiler is running, and a shared ``contextlib.nullcontext()`` otherwise.
Run a search or a build under ``torch.profiler.profile`` to record the
spans: they come out in its ``events()`` and Chrome trace beside the device
kernels, on the same clock, so every gap in the device's work falls inside a
named phase. Nothing is recorded, stored or exported otherwise.

The gate reads ``torch.autograd.profiler._is_profiler_enabled``, which the
profiler sets on start and clears on stop: a ``record_function`` costs about
as much with no profiler running as with one, tens of times the flag's
read, and the beam loop opens several spans a step.
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _autograd_profiler

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the profiler's range ``repro_torch.<name>`` while
    a profiler runs, else a no-op."""
    if _autograd_profiler._is_profiler_enabled:
        return _autograd_profiler.record_function(PREFIX + name)
    return _OFF
