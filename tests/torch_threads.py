"""One torch thread for a test module, restored after it.

The tier-1 run puts several pytest workers on one host, each with
torch's default of one intra-op thread per core; modules that run many
small torch ops then spend most of their time in oversubscribed thread
pools.  A module imports :func:`one_torch_thread` to run on one thread.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
