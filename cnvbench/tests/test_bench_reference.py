"""The plain reference against the port's CPU path, at sizes a test holds.

The port runs its plain versions on the CPU; the comparison of a whole small
run (cnvbench/check.py) must pass within the cells' limits, for both
configurations and both analysis modes.  The reference itself imports
nothing of the port (test_bench_harness.py checks that)."""

import numpy as np
import pytest
import torch

from cnvbench import reference, run
from cnvbench.genomes import make_genome
from cnvbench.tests.cells import CELLS, small


@pytest.mark.parametrize("name", CELLS)
def test_port_within_limits(name):
    out = run.run_cell(small(name), 2_150_000_001, 0.2, False, "cpu")
    assert out["correct"], out["checks"]
    for k, v in out["checks"].items():
        assert v["value"] <= v["limit"] / 10, (k, v)


@pytest.mark.parametrize("config", ["default_i6", "coords_i3"])
def test_smoothing_operator_matches_port(config):
    """The reference's per-chromosome operators, laid into one banded
    matrix, equal the port's operator weight for weight (full width)."""
    from infercnv_tpu_torch.core.genome import GeneOrder
    from infercnv_tpu_torch.ops.layout import (coordinate_smoothing_operator,
                                               smoothing_operator)

    cfg = run.load_json(run.HERE / "configs" / f"{config}.json")
    g = make_genome(cfg["genome"])
    eng = cfg["engine"]
    go = GeneOrder(names=tuple(f"g{i}" for i in range(g.num_genes)),
                   chr_names=g.chr_names, chr_ids=g.chr_ids, start=g.start,
                   stop=g.stop)
    op = (coordinate_smoothing_operator(go, eng["window_length"])
          if eng["smooth_method"] == "coordinates"
          else smoothing_operator(go, eng["window_length"], eng["smooth_method"]))
    G = g.num_genes
    dense = np.zeros((G, G))
    for b, e, w in reference.smoothing_blocks(g, eng["smooth_method"],
                                              eng["window_length"]):
        dense[b:e, b:e] = w
    t = op.halfband
    for d in range(op.band.shape[0]):           # band[d, g]: weight of x[g + d - t]
        off = d - t
        cols = np.arange(max(0, -off), min(G, G - off))
        np.testing.assert_allclose(dense[cols + off, cols], op.band[d, cols],
                                   rtol=0, atol=1e-15)
    assert reference.band_nonzeros(g, eng["smooth_method"], eng["window_length"]) \
        == int(np.count_nonzero(op.band))


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -3.0 - 2.0 ** -12])
    got = reference.round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0]


def test_viterbi_best_path_scores_its_best():
    """The reference's backtraced path scores exactly its forward maximum,
    and one changed state scores lower."""
    cell = small("cohort64k_cells.default_i6")
    g = make_genome(cell["config"]["genome"])
    ref = reference.Reference(cell["config"], g, "cpu")
    means, sigma, t = ref.hmm()
    x = 1.0 + 0.3 * torch.randn((3, g.num_genes), dtype=torch.float64,
                                generator=torch.Generator().manual_seed(0))
    best, states = ref.viterbi(x, means, sigma, t)
    torch.testing.assert_close(ref.path_score(x, states, means, sigma, t), best,
                               rtol=0, atol=1e-9)
    moved = states.clone()
    moved[0, 5] = moved[0, 5] % 6 + 1
    assert bool((ref.path_score(x, moved, means, sigma, t)[0] < best[0] - 1).any())
