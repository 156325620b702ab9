"""Shared fixture of the tests/test_torch_*.py files.

The suite runs in several worker processes on one host; PyTorch's default
intra-op thread pool (one thread per core) in every worker oversubscribes
the cores and slows every test file. Each port test module caps PyTorch at
two threads while it runs and restores the previous count afterwards.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def torch_two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
