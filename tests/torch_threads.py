"""One intra-op torch thread for a port test module.

The suite runs six workers on the machine's cores, and the port's tests are
mostly thousands of small ops: with torch's default pool (a thread a core)
in every worker, the workers' threads contend for the cores and a module ran
up to ten times slower than on one thread. A module imports the fixture:

    from torch_threads import one_thread  # noqa: F401  (autouse)
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
