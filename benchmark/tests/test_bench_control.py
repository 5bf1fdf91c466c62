"""The control on the card: the reference in TF32 (the precision below the
configurations' float32 with TF32 off) put in the program's place must
fail the check, and the program pass it, at a size a test run can hold
(a one-second window; the check's sample is the cell's own). The full
readings at the cells' sizes: ``benchmark/calibrate.py``, PERF.md section 2.

    python -m pytest benchmark/tests/test_bench_control.py -q -m cuda
"""

import pytest
import torch

import calibrate
from core import spec

CELLS = ["proj-frame256", "kd-static256", "proj-track16"]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, card):
    c = spec.Cell(cell)
    for control, seed in ((False, 3_000_002_001), (True, 3_000_002_002)):
        row = calibrate.readings(c, seed, 1.0, [card], control)
        over = [k for k, limit in c.limits.items() if not row[k] <= limit]
        assert bool(over) == control, (row, c.limits)
