"""Fixtures that run a test's torch work on one thread.

The port's CPU tests launch many small operators; under several test
workers, each with torch's default thread count, a loaded host stalls every
parallel region.  A file opts in whole with ``from tests.torch_threads
import one_thread  # noqa: F401`` (module scope, autouse), or a test with
``@pytest.mark.usefixtures("single_thread")`` after importing
``single_thread``.  One thread changes the order of torch's reductions, so
a test whose gate a different order can cross keeps the default.
"""

from __future__ import annotations

import contextlib

import pytest
import torch


@contextlib.contextmanager
def torch_threads(n: int):
    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    with torch_threads(1):
        yield


@pytest.fixture
def single_thread():
    with torch_threads(1):
        yield
