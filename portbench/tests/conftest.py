"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the repository root. Tests marked ``chip`` need a CUDA card and skip inside
the ``cuda_device`` fixture elsewhere (run them on the card with ``-m chip``)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with -m chip")
    return torch.device("cuda", 0)
