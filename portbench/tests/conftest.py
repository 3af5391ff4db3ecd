"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from the
root of the checkout. A test marked ``chip`` needs an NVIDIA card and skips
without one (``card`` fixture)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the run measures the port on the card")
    return "cuda"
