"""pytest settings and fixtures of the benchmark's own tests
(``test_annbench_*.py``): the ``cuda`` marker, and runs of a cell on the CPU
at a tiny size through the harness's whole path."""
import io
import json
import time
from contextlib import redirect_stderr
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
# a cell's own configuration, parameters and limits, cut to a size the CPU
# runs in seconds
SMALL = {"config": {"data": {"n": 1200, "d": 8, "latent": 3}},
         "params": {"batch_rows": 64, "trace_batches": 1,
                    "check": {"recall_sample": 64, "graph_sample": 32}}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips inside its fixture where none is visible")


@pytest.fixture
def run_small(monkeypatch):
    """run_small(cell, trace=False, root=ROOT, seed=...) -> (rc, result
    dict or None, stderr lines): one run of ``cell`` on the CPU at SMALL's
    size, through ``harness.run`` past its look for a card. The test
    process may hold JAX from other test files, so the run's own look for
    it is left out here; ``test_annbench_imports`` makes it in a fresh
    process."""
    import torch

    from annbench import harness

    monkeypatch.setattr(harness, "forbidden_loaded", lambda: [])

    def run(cell, trace=False, root=ROOT, seed=2**31 + 12345, overrides=SMALL, seconds=0.01):
        out, err = io.StringIO(), io.StringIO()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)      # tiny ops: threads only contend with other workers
        try:
            with redirect_stderr(err):
                rc = harness.run(root, cell, seed, seconds, trace, time.perf_counter(),
                                 device="cpu", require_gpu=False, overrides=overrides, out=out)
        finally:
            torch.set_num_threads(threads)
        lines = out.getvalue().strip().splitlines()
        return rc, (json.loads(lines[-1]) if lines else None), err.getvalue().splitlines()
    return run


@pytest.fixture
def cuda_device():
    """The card, or a skip where none is visible (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")

