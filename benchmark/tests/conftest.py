"""Settings of the benchmark's own tests, which ``tests/conftest.py`` does
not reach: the ``gpu`` marker for tests that need the card, and the
fixture that decides, when a test runs, whether there is one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
