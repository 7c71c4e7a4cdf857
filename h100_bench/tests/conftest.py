"""The benchmark's own tests: on the CPU at small sizes, and one on the
card, which skips where torch sees no card.

    python -m pytest h100_bench/tests -q
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
