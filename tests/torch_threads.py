"""One torch intra-op thread for the port's heavy CPU tests.

Under the suite's parallel workers (``pytest -n 6``), torch's intra-op
thread pool in every worker oversubscribes the host's cores, and a heavy
test's time grows many times over. A test file imports
``one_torch_thread`` for the tests that ask for it, or
``one_torch_thread_per_module`` (autouse) for all of its tests; the
pool's size is restored afterwards.
"""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def one_torch_thread():
    with _one_thread():
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_per_module():
    with _one_thread():
        yield
