"""A module-scoped fixture for the port's test files: torch on one
intra-op thread while the module runs.

The suite runs as several worker processes at once; torch's CPU ops at
the ports' test sizes then gain nothing from many threads, and OpenMP
threads oversubscribing the cores made the port's files about twice as
slow. Each file imports the fixture by name (``autouse``), so a worker's
thread count comes back for the next module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
