"""Tests of the benchmark harness.  They run on the CPU; a test that needs
a CUDA card takes the ``card`` fixture, which skips it without one, and is
marked ``chip``:

    python -m pytest benchmark/tests -q            # on the CPU
    python -m pytest benchmark/tests -q -m chip -s # on a card: the controls
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.device_count()
