"""One torch intra-op thread for each port test module.

The suite runs as several pytest-xdist workers on one machine. With
torch's default of one OpenMP thread per core in every worker, the
workers' threads oversubscribe the cores, and the port's tests (many
small ops) ran several times slower when their files overlapped. One
thread is as fast for them alone. A module imports the fixture to opt in
(``from _torch_threads import one_torch_thread``); the previous count is
restored when the module's tests end.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
