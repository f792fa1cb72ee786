"""Tests of the benchmark's harness and reference.

    python -m pytest benchmark/tests -q            # on the CPU
    python -m pytest benchmark/tests -q -m chip -s # on a machine with a card

Tests marked ``chip`` need a CUDA card and skip without one, deciding
inside the test.
"""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
