"""The comparison refuses a broken timed path and the control.

Each fault of cnvbench/faults.py is planted under the port for a whole small
run, whose look for a GPU is skipped (run_cell on the CPU); and the control,
the reference in TF32 in the program's place, runs the same small cells.
Every one must come out not correct."""

import pytest

from cnvbench import faults, run
from cnvbench.tests.cells import CELLS, small


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_refused(name, fault):
    with faults.planted(fault):
        # a window of a few jobs, so that a sample other than the first is
        # compared (stale statistics are right for the first)
        out = run.run_cell(small(name), 2_150_000_002, 1.0, False, "cpu")
    assert out["jobs"] >= 2
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_refused(name):
    out = run.run_cell(small(name), 2_150_000_003, 0.2, False, "cpu",
                       control=True)
    assert not out["correct"], out["checks"]
    assert out["checks"]["resid_err"]["value"] > 3 * out["checks"]["resid_err"]["limit"]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_cell_and_control_on_card(name, cuda_device):
    """On the GPU at the cells' widths (8448 genes), a smaller cohort: the
    port passes and the control does not."""
    cell = small(name, genes=8448)
    cell["traffic"].update(cells_per_sample=8192, ref_cells=1640, subclusters=16,
                           planted_subclusters=8, chunk_cells=4096)
    assert run.run_cell(cell, 2_150_000_004, 1.0, False, cuda_device)["correct"]
    assert not run.run_cell(cell, 2_150_000_005, 1.0, False, cuda_device,
                            control=True)["correct"]
