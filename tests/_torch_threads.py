"""PyTorch on one CPU thread while a port test module runs under
pytest-xdist.

A test module applies it by importing the autouse fixture:

    from _torch_threads import one_torch_thread  # noqa: F401

The run's xdist workers already take the CPU's cores, and a worker's
default of one PyTorch thread a core made the port's files contend with
one another and with the interpreted JAX compiles; on the small meshes of
these tests, threads also add about tenfold to the forward-derivative
work (tests/_torch_euler.py). The module's previous thread count comes
back after its last test, and without xdist (one process) PyTorch keeps
its threads.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
