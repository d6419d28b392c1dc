"""A module-scoped autouse fixture for the port's test files whose fits are
tiny (hidden widths of 32-64): torch's intra-op thread pool there buys no
speed, and under the suite's six workers on the CPU's cores its threads
only contend with the other workers'. A file imports it by name; every
comparison in such a file runs in this one process, so none compares
results across thread counts."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
