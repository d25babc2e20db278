"""Tests of the benchmark's pieces. They run on the CPU at small sizes;
those that need the card are marked ``card`` and skip, decided inside a
fixture, where there is none. Run them from the repository's root:
``python -m pytest slambench/tests -q``."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(BENCH / "reference"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the control runs on the card only")
    return torch.device("cuda", 0)
