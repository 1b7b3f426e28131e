"""pytest settings of the benchmark's own tests.

    python -m pytest featbench -q            # CPU: the `cuda` tests skip
    python -m pytest featbench -q -m cuda    # on a machine with a card

Imports nothing of the JAX package.  Whether a card is present is decided
inside the `cuda_device` fixture, never while a module is imported.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"
