"""Cells of BENCHMARK.json cut to a size the CPU tests can hold."""

import copy

from cnvbench import run

CELLS = ("cohort64k_sub.default_i6", "cohort64k_cells.default_i6",
         "cohort64k_cells.coords_i3")


def small(name: str, genes: int = 512) -> dict:
    """The cell at `genes` genes, 2 samples of 256 cells (52 reference
    cells), 4 subclusters; chunks of 128 cells (subclusters) or 64 (cells)."""
    cell = copy.deepcopy(run.load_cell(name))
    cell["config"]["genome"]["genes"] = genes
    sub = cell["traffic"]["analysis_mode"] == "subclusters"
    cell["traffic"].update(samples=2, cells_per_sample=256, ref_cells=52,
                           subclusters=4, planted_subclusters=2,
                           chunk_cells=128 if sub else 64, warm_jobs=1,
                           check={"jobs": 2, "rows_per_chunk": 4})
    return cell
