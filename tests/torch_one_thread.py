"""One PyTorch thread for the port's CPU tests.

The tier-1 run puts several pytest workers on one machine. PyTorch's CPU
ops each start a pool of as many threads as there are cores, so the
workers' pools outnumber the cores many times over, and small ops wait on
threads that are not running (the mapping loops took 30x their time
alone). The port's tests are many small ops; one thread each avoids that.
A test module takes the fixture by importing it; the count is restored
after the module."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
