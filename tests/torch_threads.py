"""One intra-op CPU thread for the port's tests (a module fixture)."""

import pytest
import torch


@pytest.fixture(scope="module")
def one_torch_thread():
    """The module's tests run on one intra-op CPU thread, then the count
    is put back. Their tensors are small: an op split over the pool costs
    more in the threads' hand-offs than it saves (a 500-row scatter_add_
    took 75 ms on 8 threads of a busy host, 0.04 ms on one). A reduction
    the pool would split sums in one order instead; the modules hold such
    values to tolerances, not bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
