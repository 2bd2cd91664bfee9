"""The benchmark's own tests: CPU tests of its yardstick, and tests marked
``cuda`` that need a card (skipped here from inside a fixture)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc; skips without them")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def cpu_knobs(monkeypatch):
    """The program's seeded draws on the CPU too: restart inits and the
    kmeans++ seeding from threefry keys, as on a card."""
    from tiny import CPU_KNOBS

    for k, v in CPU_KNOBS.items():
        monkeypatch.setenv(k, v)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: several test workers share the cores."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
