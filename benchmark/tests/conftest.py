"""Tests of the benchmark: ``python -m pytest benchmark/tests -q`` from the
root of the checkout. Tests marked ``card`` need a CUDA device; they decide
inside the test (the ``cuda`` fixture) whether there is one, and skip
without it."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")
