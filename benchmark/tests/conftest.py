"""The benchmark's own tests: `python -m pytest benchmark/tests`. Tests
that need a card carry the `chip` marker and decide inside a fixture
whether one is present."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures only on the chip")
    return torch.cuda.get_device_name(0)
