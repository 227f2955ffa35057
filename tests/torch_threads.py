"""One torch intra-op thread for a port test module (a module-scoped
autouse fixture; import it into the module: ``from torch_threads import
one_torch_thread``).

The port's CPU tests run small tensors, which gain nothing from more
threads, and the suite runs them in several worker processes at once: with
torch's default of a thread per core in every worker the thread pools
oversubscribe the cores and wait on each other (a 32x32 GroupNorm took 100
times as long, and one file's port-only training test ten times)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
