"""Tests of the benchmark (``python -m pytest perfbench/tests``).

Most run on the CPU at small sizes.  Those that need an NVIDIA card take
the ``card`` fixture, which skips without one; the marker ``card`` names
them (``-m card`` on the card)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA card (skips without one)")
    # the CPU tests' models are tiny: one thread each keeps workers that
    # run side by side from starving one another
    import torch
    torch.set_num_threads(1)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
