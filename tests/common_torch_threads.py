"""One intra-op thread for each test of the port's plain kernels.

The plain kernels run thousands of ops on tensors of a few hundred lanes,
which gain nothing from more threads. With every core's worth of OpenMP
threads in each of the suite's parallel workers (`-n 6` on an 8-core
host), the threads' waiting slowed a 128-lane verification from 1.3 s to
138 s. A test module imports `one_torch_thread` to run each of its tests
on one thread; the count is restored after each test.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
