"""Tests of the benchmark itself (``python -m pytest portbench/tests``).

Tests that need a CUDA card carry the ``card`` marker and decide inside
the test whether there is one: they skip without it. On the card:
``python -m pytest portbench/tests -m card``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
