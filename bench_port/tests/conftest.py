"""The benchmark's own tests: the reference against the program's float modules at small sizes on the
CPU, the work counts, the window's arithmetic, the check under planted faults, the controls, and that
nothing the harness runs loads JAX.  Tests that need a card carry the ``cuda`` marker and skip,
decided inside the test, where there is none:

    python -m pytest bench_port/tests -q
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() is false")


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: several test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
