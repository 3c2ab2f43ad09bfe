"""The benchmark's tests: they run on the CPU at small sizes, except those
marked ``cuda``, which need the card and skip without one (run them there
with ``python -m pytest -q benchmark/tests -m cuda``)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    import torch

    torch.set_num_threads(4)
