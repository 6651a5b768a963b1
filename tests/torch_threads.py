"""Shared fixture for the port's CPU tests that run JAX in the same process.

JAX's CPU thread pool and torch's OpenMP threads contend when both live in
one process; the port's small CPU ops run several times faster on a single
torch thread there. Results do not depend on the thread count: the parity
tests hold either way.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
