"""Tests of the benchmark: ``pytest perfbench/tests``.

On the CPU they check the benchmark's files, its counts, its plain
reference against the port's plain path, and whole runs at small sizes with
faults planted. Tests marked ``card`` need a CUDA card and skip without one;
whether there is one is decided inside the ``card`` fixture, never while a
module is imported.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
