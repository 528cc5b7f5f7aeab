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


def build_jax_native_library():
    """Build the JAX package's native mesh library (iron_tpu/native) when it
    is missing or stale, with the JAX loader's own g++ command, into a file
    of this process's own that is then renamed into place: the JAX loader
    builds into one fixed temporary name, which two pytest workers building
    at once would both write."""
    import os
    import subprocess
    from iron_tpu import native
    if os.path.exists(native._SO) and \
            os.path.getmtime(native._SO) >= os.path.getmtime(native._SRC):
        return
    tmp = f"{native._SO}.{os.getpid()}.tmp"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp", native._SRC,
                    "-o", tmp], check=True, capture_output=True)
    os.replace(tmp, native._SO)
