"""The benchmark's own tests run on the CPU from the checkout's root:

    python -m pytest benchmark/tests -q

Tests that need the card carry the repository's ``cuda`` marker and skip
without one, deciding inside the ``card`` fixture."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda")


@pytest.fixture
def card_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
