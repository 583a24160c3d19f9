"""One torch intra-op thread for each port test module that imports it.

The suite runs files in parallel worker processes (``-n 6 --dist
loadfile``), where torch's default of one intra-op thread per core in
every worker oversubscribes the CPU many times over: a train step or a
prefill of the small test models then takes minutes instead of a
second.  Importing ``one_thread`` into a test module makes it autouse
there; the worker's count is restored after the module, so the next
file in the worker starts from the default.
"""
import pytest


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
