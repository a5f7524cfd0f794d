"""The torch thread count of the port's CPU test modules.

The Tier-1 run puts six pytest workers on the host's cores at once, and
torch's default of one OpenMP thread per core in every worker
oversubscribes them many times over: six of the port's heaviest files,
one a worker, took 1090.8 s together with the default threads and 238.1 s
with this fixture (an 8-core host). A module that imports
``torch_threads`` runs its tests on ``THREADS`` threads and restores the
count after its last test.

Importing this module imports no JAX.
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)
