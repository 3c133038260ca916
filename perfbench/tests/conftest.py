"""Tests of the benchmark harness. They run on the CPU at small sizes;
those that need a CUDA card are marked ``cuda`` and skip without one (the
``card`` fixture decides, never an import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
