"""The control: each cell with the port's float32 path in place of the
float64 that its configuration states comes out not correct.

Runs on the card at the cell's own size (``-m gpu``), three seeds a cell;
skips without enough CUDA devices.  Readings for the limits come from
``python3 -m qbench.control``.
"""

import pytest

from qbench import control, harness

SPEC = harness.manifest()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture
def devices_for():
    import torch

    def need(cell):
        chips = harness.cell_entry(SPEC, cell)["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            pytest.skip(f"needs {chips} CUDA device(s)")

    return need


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_is_not_correct(devices_for, cell):
    devices_for(cell)
    rows = list(control.readings(cell, [101, 102, 103], 5.0, dtype="float32"))
    assert rows and not any(r["correct"] for r in rows), rows
