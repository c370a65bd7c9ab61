"""One torch intra-op thread while a test module's CPU cases run.

The suite runs its files in several worker processes at once. torch's
default of one intra-op thread per core then puts several times more
threads than cores on the machine, and small CPU cases spend most of
their time waiting at the barriers of torch's parallel regions; the
suite's parallel run took about twice as long on the default threads.
A module opts in by importing the fixture:

    from _torch_threads import one_torch_thread  # noqa: F401

The count is put back when the module's cases are done, so the modules
that run after it in the same worker see torch's default.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
