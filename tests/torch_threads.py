"""One intra-op thread for the port's CPU tests.

The suite runs several pytest workers and, beside them, spawned gloo ranks
and reference subprocesses, on a few cores. PyTorch's CPU ops default to
one OpenMP thread per core, and those threads spin while they wait: with
every core already taken, a small op then costs ten times its work. Each
port test module imports ``one_intra_op_thread`` (an autouse fixture), so
its tests run on one thread and the thread count is restored after it.
No check depends on the count: a bitwise check compares two runs of one
process, or a run with spawned ranks that take one thread too.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
