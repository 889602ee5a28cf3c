"""The benchmark's CPU tests: ``python -m pytest -q bench/tests`` from the
repository's root (tests marked ``gpu`` need a CUDA card and skip without
one)."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
