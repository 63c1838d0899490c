"""Tests of the benchmark itself. Those that need an NVIDIA card carry
the ``card`` marker and ask for the ``card`` fixture, which skips them
where there is none; the others run on the CPU at small sizes."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skipped where CUDA is absent")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def root():
    return ROOT


@pytest.fixture(scope="session")
def manifest(root):
    from benchmark.harness.core import Manifest

    return Manifest(root)
