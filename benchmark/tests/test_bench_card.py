"""On the card, at each cell's own size: a short run is correct and the
control (the reference in TF32 in the program's place) is not.  Run on
the card with ``python3 -m pytest benchmark/tests -m cuda``; elsewhere
these tests skip."""

import pytest

from benchmark import control
from benchmark.manifest import Cell, manifest

CELLS = [w["name"] for w in manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_passes_and_control_fails(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    row, = control.readings(Cell(name), [2**31 + 2024], 2.0)
    assert row["program_correct"], row["program"]
    assert not row["control_correct"], row["control"]
