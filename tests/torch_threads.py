"""One torch intra-op thread for the port's CPU parity tests.

Their tensors are small (a few thousand rows), where torch's intra-op
threads only add hand-off cost, and the test run's parallel workers already
share the machine's cores: with every worker's pool at full width the
threads oversubscribe the cores, and a fit that takes 5 s alone took
minutes. A test module imports the fixture to use it."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
