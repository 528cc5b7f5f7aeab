"""Shared fixture of the PyTorch-port tests (tests/test_torch_*.py)."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port's CPU ops on one thread: the suite runs several pytest
    workers side by side, and PyTorch's default of one thread per core in
    each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
