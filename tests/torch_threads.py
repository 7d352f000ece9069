"""One PyTorch intra-op thread for the port's CPU test modules.

A module imports the fixture (`from torch_threads import _one_thread`),
which then applies, module-scoped and autouse, to every test there; or
it runs one call under `one_thread()`.  The test workers share the
host's cores: several workers each running a thread per core slow one
another down many-fold, while one thread each runs this suite's small
tensors as fast as several do.  An autouse fixture is set up before the
module's other fixtures of its scope, so a module-scoped Context is
built under it too.
"""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield
