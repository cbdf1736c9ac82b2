"""One torch intra-op thread while a port test module runs.

The port's tests run small tensors, where torch's intra-op pool buys
nothing; under the suite's xdist workers (one process per core) every
worker's pool would spin on every core, and the reference's compiles in
the other workers wait for the CPU.  Each ``tests/test_torch_*.py``
imports :func:`one_torch_thread`, an autouse module fixture that sets one
thread for the module and restores the count after it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
