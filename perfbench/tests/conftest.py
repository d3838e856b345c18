"""pytest settings of the benchmark's own tests: the `cuda` marker (tests
that need a card skip elsewhere, decided inside each test)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skipped elsewhere")


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
