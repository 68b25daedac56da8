"""The port's plots (device="cpu") against the JAX package's on one object:
plot_cnv and plot_subclusters under the options users pass (the
k_obs_groups split, plot_chr_scale, hclust_method, ref_contig, the custom
and colour-safe palettes, dynamic_resize, a downsampled pane, write_expr,
write_phylo) write the same files, their text outputs and newick
byte-equal and each PNG's 24x24 block fingerprint within 0.02; and the
Bayes plots: geweke_z equal, the probability plots' files and pages, the
MCMC diagnostics and the P(normal) heatmap alike on one BayesResult."""

import numpy as np
import pytest

import infercnv_tpu.models.bayes as jbayes
import infercnv_tpu.viz.bayes_plots as jbp
import infercnv_tpu.viz.heatmap as jh
import infercnv_tpu.viz.subclusters as jsub
import infercnv_tpu_torch.models.bayes as tbayes
import infercnv_tpu_torch.viz.bayes_plots as tbp
import infercnv_tpu_torch.viz.heatmap as th
import infercnv_tpu_torch.viz.subclusters as tsub

from test_torch_heatmap import _objects
from torch_port_util import assert_same_outputs, one_thread_a_pool

#: each case of plot_cnv, as keyword arguments
CASES = {
    "k_obs_groups": dict(cluster_by_groups=False, k_obs_groups=3),
    "plot_chr_scale": dict(plot_chr_scale=True, chr_lengths=[70_000, 60_000, 65_000, 80_000]),
    "average": dict(hclust_method="average"),
    "ref_contig": dict(ref_contig="chr2"),
    "custom_color_pal": dict(custom_color_pal=["#2166AC", "#F7F7F7", "#B2182B"]),
    "color_safe_pal": dict(color_safe_pal=True),
    "dynamic_resize": dict(dynamic_resize=0.5),
    "downsampled": dict(max_pane_rows=24),
    "write_expr": dict(write_expr=True, x_center=1.0, x_range=(0.7, 1.3)),
    "write_phylo": dict(write_phylo=True),
}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_a_pool():
        yield


@pytest.mark.parametrize("case", list(CASES))
def test_plot_cnv_matches(tmp_path, case):
    kw = CASES[case]
    n_tumor = 210 if case == "dynamic_resize" else 30   # > 200 observations
    jo, to = _objects(n_tumor=n_tumor, genes_per_chr=40)
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    jh.plot_cnv(jo, str(dj), output_filename="p", png_res=50, **kw)
    th.plot_cnv(to, str(dt), output_filename="p", png_res=50, device="cpu", **kw)
    names = assert_same_outputs(str(dt), str(dj))
    want = {"p.png", "p.observation_groupings.txt", "p.heatmap_thresholds.txt"}
    if case == "write_expr":
        want |= {"p.observations.txt", "p.references.txt"}
    if case == "write_phylo":
        want |= {"p.observations_dendrogram.txt"}
    assert set(names) == want


def test_plot_subclusters_matches(tmp_path):
    jo, to = _objects(genes_per_chr=40)
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    jsub.plot_subclusters(jo, str(dj), png_res=50, max_pane_rows=16)
    tsub.plot_subclusters(to, str(dt), png_res=50, max_pane_rows=16, device="cpu")
    assert len(assert_same_outputs(str(dt), str(dj))) == 3
    jo.tumor_subclusters = to.tumor_subclusters = None
    assert tsub.plot_subclusters(to, str(dt), device="cpu") is None


def test_plot_cnv_timings_split_data_and_render(tmp_path):
    _jo, to = _objects(genes_per_chr=20)
    t = {}
    th.plot_cnv(to, str(tmp_path), png_res=30, device="cpu", timings=t)
    assert set(t) == {"data", "render"} and min(t.values()) > 0


def test_geweke_z_and_gelman_rubin_match():
    rng = np.random.default_rng(1)
    traces = rng.normal(0, 1, (3, 400, 5, 6)) + np.linspace(0, 1, 400)[None, :, None, None]
    np.testing.assert_array_equal(tbp.geweke_z(traces), jbp.geweke_z(traces))
    np.testing.assert_array_equal(tbp.geweke_z(traces, 0.2, 0.3),
                                  jbp.geweke_z(traces, 0.2, 0.3))
    np.testing.assert_array_equal(tbp.gelman_rubin(traces), jbp.gelman_rubin(traces))


def _results(R: int, n_cells: int, seed: int = 3):
    """(JAX BayesResult, port BayesResult) with the same fields."""
    rng = np.random.default_rng(seed)
    names = [f"chr{1 + i % 3}-region_{i}" for i in range(R)]
    probs = rng.dirichlet(np.ones(6), size=R).T
    cells = [rng.dirichlet(np.ones(6), size=n_cells).T for _ in range(R)]
    traces = rng.dirichlet(np.ones(6), size=(4, 60, R))
    out = []
    for mod in (jbayes, tbayes):
        r = mod.BayesResult()
        r.cnv_region_names = list(names)
        r.cnv_state_probabilities = probs
        r.cell_probabilities = list(cells)
        r.theta_traces = traces
        out.append(r)
    return out


def test_probability_plots_pages_match(tmp_path):
    """Past 200 regions the region bars take a second page, past 64 the
    cell panels (tests/test_bayes_plots.py's paging case)."""
    rj, rt = _results(R=201, n_cells=3)
    rj.cell_probabilities = rt.cell_probabilities = rt.cell_probabilities[:65]
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    for mod, r, d in ((jbp, rj, dj), (tbp, rt, dt)):
        mod.plot_cnv_probabilities(r, str(d))
        mod.plot_cell_probabilities(r, str(d))
    names = assert_same_outputs(str(dt), str(dj))
    pages = {f for f in names if ".page" in f}
    assert pages == {"cnvProbs.page2.png", "cellProbs.page2.png"}


def test_mcmc_diagnostics_and_normal_probabilities_match(tmp_path):
    rj, rt = _results(R=8, n_cells=20)
    jo, to = _objects(genes_per_chr=20)
    rng = np.random.default_rng(4)
    regions = [{"name": n, "cell_idx": np.sort(rng.choice(60, 12, replace=False)),
                "gene_idx": np.arange(8 * i, 8 * i + 12)}
               for i, n in enumerate(rj.cnv_region_names)]
    rj.regions = rt.regions = regions
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    jbp.mcmc_diagnostic_plots(rj, str(dj))
    jbp.post_prob_normal_heatmap(jo, rj, regions, str(dj))
    t = {}
    tbp.mcmc_diagnostic_plots(rt, str(dt))
    tbp.post_prob_normal_heatmap(to, rt, regions, str(dt), timings=t)
    assert set(assert_same_outputs(str(dt), str(dj))) == {
        "MCMC_Diagnostics.png", "MCMC_Diagnostics.txt",
        "infercnv.NormalProbabilities.PostFiltering.png"}
    assert set(t) == {"data", "render"}
