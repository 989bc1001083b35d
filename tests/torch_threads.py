"""One intra-op torch thread for a test module's CPU work.

The CPU tests run as several pytest workers at once (``-p xdist -n 6``).
torch's OpenMP pool busy-waits between parallel regions, so each worker's
pool spins on the cores the other workers need: a module of small tensors
ran 35-40 times slower beside five others than alone (the hymba case of
``test_torch_grad_scopes.py``: 4 s alone, 170 s as one of six). A module
imports the fixture to run on one thread::

    from torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The module's tests on one intra-op thread; the count is restored
    after them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
