"""Tests of the benchmark's harness, on the CPU (``python3 -m pytest
portbench/tests``; the repository's tier-1 suite does not collect them).
Tests that need a card carry the ``cuda`` marker and skip without one; the
look for a card happens inside the ``cuda_card`` fixture, never at import."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU and nvcc; skipped elsewhere")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
