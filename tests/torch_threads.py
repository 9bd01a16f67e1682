"""One PyTorch thread while a port test module runs.

The suite runs in several pytest-xdist workers on one host (the tier-1
command: 6 workers, ``--dist loadfile``).  PyTorch's intra-op pool starts
a thread per core in every worker, so six pools (beside XLA's) spin on the
same cores and the workers' compiles and CPU kernels wait on each other:
on an 8-core host the whole suite took 1321 s with the default pools and
647 s with one torch thread per worker.  The port's CPU tests import
:func:`one_torch_thread`, an autouse module fixture: torch runs on one
thread for the module's tests and gets its thread count back after.  The
results do not depend on it (the same tests pass either way).
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
