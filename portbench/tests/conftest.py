"""CPU tests of the benchmark (run: python -m pytest portbench/tests -q,
from the root of the repo).  The card's test is marker ``cuda`` and
skips, from inside a fixture, where there is no CUDA device."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's runs need the card")
    return "cuda"
