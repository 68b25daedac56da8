"""The port's run() (device="cpu") against the JAX package's run() on
tests/test_pipeline.py's synthetic object (a planted loss on chr2 and gain
on chr3 in the tumour cells).

Same results: the final expr within rtol = atol = 2e-5, the HMM states
equal, and the 17_HMM_pred region reports byte-equal.  The i3 HMM draws
nothing; for i6 the port's build_hspike and cnv_mean_sd_trend_fit are
replaced by the reference's hspike and trend fits, carried across, since
the two packages draw different random bits (their draws are held to their
distribution in tests/test_torch_hspike.py), and so is the reference's PCA
range-finder draw for the Leiden partition.  The options that were refused
until the mesh and splatter were ported run now
(test_unported_options_are_refused_before_any_work: a mismatched mesh is
still refused before any work); the options that were refused until the
op-by-op steps, the DE mask,
the Leiden, random_trees and per-chromosome partitions and the plots were
ported run against the reference (test_formerly_refused_options_match_the_reference;
tests/test_torch_pipeline_ops.py holds them in more depth), and so do the
Bayesian filter of steps 18-19 (test_bayes_filter_matches_the_reference:
exactly with one stand-in sampler in both packages, within Monte Carlo
error with the real ones) and the checkpoints and RDS output
(test_save_rds_matches_the_reference; tests/test_torch_checkpoint_rds.py
holds the files and resume in more depth), and run() with every plot
(test_run_with_plots_matches_the_reference: the same files, text outputs
byte-equal, each PNG's block fingerprint within 0.02)."""

import filecmp
import os

import numpy as np
import pytest

import infercnv_tpu.models.bayes as jbayes
import infercnv_tpu.runner.pipeline as jp
import infercnv_tpu_torch.models.bayes as tbayes
import infercnv_tpu_torch.runner.pipeline as tp
from infercnv_tpu.io.rds import read_rds_infercnv as j_read_rds
from infercnv_tpu_torch.io.rds import read_rds_infercnv as t_read_rds
from infercnv_tpu_torch.runner import checkpoint as tckpt
from infercnv_tpu_torch.interop import infercnv_from_numpy, trend_fits_from_numpy

from test_pipeline import make_synthetic
from torch_port_util import assert_same_outputs, one_thread_a_pool, standin_gibbs

KW = dict(window_length=21, no_plot=True, BayesMaxPNormal=0, save_rds=False,
          denoise=True)
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test with one thread in torch's and the BLAS pools: under the
    suite's several worker processes, pools of a thread a core spin
    against each other (torch_port_util.one_thread_a_pool)."""
    with one_thread_a_pool():
        yield


def _assert_same_run(rt, rj, dt, dj):
    np.testing.assert_allclose(rt.infercnv_obj.expr, rj.infercnv_obj.expr, **TOL)
    np.testing.assert_array_equal(rt.hmm_states, rj.hmm_states)
    np.testing.assert_array_equal(rt.hmm_proxy_values, rj.hmm_proxy_values)
    def step17(d):   # the region reports, not the step-17 checkpoint
        return sorted(f for f in os.listdir(d)
                      if f.startswith("17_HMM_pred") and not f.endswith(".npz"))

    reports = step17(dj)
    assert len(reports) == 4
    assert reports == step17(dt)
    for f in reports:
        assert filecmp.cmp(os.path.join(dt, f), os.path.join(dj, f), shallow=False), f


def _pair(tmp_path, obj_kw=None, **kw):
    jo = make_synthetic(**(obj_kw or {}))
    to = infercnv_from_numpy(vars(jo))
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    rj = jp.run(jo, out_dir=dj, **{**KW, **kw})
    rt = tp.run(to, out_dir=dt, device="cpu", **{**KW, **kw})
    return rt, rj, dt, dj


def test_i3_samples_matches(tmp_path):
    rt, rj, dt, dj = _pair(tmp_path, dict(del_factor=0.7, amp_factor=1.3),
                           HMM=True, HMM_type="i3", analysis_mode="samples",
                           HMM_report_by="consensus")
    _assert_same_run(rt, rj, dt, dj)
    assert os.path.exists(os.path.join(dt, "step_timings.tsv"))


@pytest.fixture
def carried(monkeypatch):
    """Run the reference first; the port then takes the reference's hspike
    (as built at step 3) and trend fits (as fitted at step 17)."""
    cap = {}
    build, fit = jp.build_hspike, jp.hmm_mod.cnv_mean_sd_trend_fit

    def j_build(*a, **k):
        h = build(*a, **k)
        cap["hspike"] = infercnv_from_numpy(vars(h))
        return h

    def j_fit(*a, **k):
        cap["fits"] = fit(*a, **k)
        return cap["fits"]

    monkeypatch.setattr(jp, "build_hspike", j_build)
    monkeypatch.setattr(jp.hmm_mod, "cnv_mean_sd_trend_fit", j_fit)
    monkeypatch.setattr(tp, "build_hspike", lambda *a, **k: cap["hspike"])
    monkeypatch.setattr(tp.hmm_mod, "cnv_mean_sd_trend_fit",
                        lambda *a, **k: trend_fits_from_numpy(cap["fits"]))
    return cap


@pytest.mark.parametrize("mode", [
    dict(analysis_mode="samples", HMM_report_by="consensus"),
    dict(analysis_mode="subclusters", tumor_subcluster_partition_method="qnorm"),
    dict(analysis_mode="cells", HMM_report_by="cell"),
])
def test_i6_with_the_reference_hspike_matches(tmp_path, carried, mode):
    rt, rj, dt, dj = _pair(tmp_path, HMM=True, HMM_type="i6", **mode)
    _assert_same_run(rt, rj, dt, dj)
    np.testing.assert_allclose(rt.infercnv_obj.hspike.expr,
                               rj.infercnv_obj.hspike.expr, **TOL)


@pytest.mark.parametrize("sim_method", ["meanvar", "simple"])
def test_i6_untouched_calls_the_planted_cnvs(tmp_path, sim_method):
    obj = infercnv_from_numpy(vars(make_synthetic()))
    res = tp.run(obj, out_dir=str(tmp_path), device="cpu", HMM=True, HMM_type="i6",
                 analysis_mode="subclusters", tumor_subcluster_partition_method="qnorm",
                 sim_method=sim_method, **KW)
    st = res.hmm_states
    o = res.infercnv_obj
    tumour, ref = o.all_obs_idx(), o.all_ref_idx()
    assert (st[ref] == 3).mean() > 0.95
    assert (st[np.ix_(tumour, o.gene_order.chr_gene_indices("chr2"))] < 3).mean() > 0.8
    assert (st[np.ix_(tumour, o.gene_order.chr_gene_indices("chr3"))] > 3).mean() > 0.8
    assert obj.expr is not o.expr          # the caller's object is untouched


#: the options refused until the mesh (ROADMAP A8) and splatter (A9) were
#: ported; the test keeps its name and cases
REFUSED = [
    (dict(n_devices=2), "A8"),
    (dict(HMM=True, sim_method="splatter"), "A9"),
]


@pytest.mark.parametrize("kw,item", REFUSED)
def test_unported_options_are_refused_before_any_work(tmp_path, kw, item):
    """Nothing is refused as unported any more: each formerly refused
    option runs (tests/test_torch_mesh.py and tests/test_torch_splatter.py
    hold it to the reference), and a mesh of another device type than the
    run's is refused before any work."""
    args = {**KW, "analysis_mode": "samples", **kw}
    obj = infercnv_from_numpy(vars(make_synthetic(n_normal=4, n_tumor=4, genes_per_chr=10)))
    res = tp.run(obj, out_dir=str(tmp_path / "ran"), device="cpu", **args)
    assert res.infercnv_obj.num_cells == obj.num_cells
    if item == "A9":
        assert res.hmm_states is not None
        assert res.infercnv_obj.hspike is not None
    out = tmp_path / "never"
    import torch
    from infercnv_tpu_torch.parallel.stats import CellMesh

    with pytest.raises(ValueError, match="device"):
        tp.run(obj, out_dir=str(out), device="cpu",
               mesh=CellMesh([torch.device("cuda", 0)]), **args)
    assert not out.exists()


def test_default_device_is_cuda(tmp_path):
    obj = infercnv_from_numpy(vars(make_synthetic(n_normal=4, n_tumor=4, genes_per_chr=10)))
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.run(obj, out_dir=str(tmp_path), analysis_mode="samples", **KW)


@pytest.mark.parametrize("step", [1, 2, 3, 15, 16, 17, 19, 20, 22])
def test_up_to_step_returns_the_reference_object(tmp_path, step):
    jo = make_synthetic(n_normal=12, n_tumor=12, del_factor=0.7, amp_factor=1.3)
    to = infercnv_from_numpy(vars(jo))
    kw = dict(KW, HMM=True, HMM_type="i3", analysis_mode="samples", up_to_step=step)
    rj = jp.run(jo, out_dir=str(tmp_path / "j"), **kw)
    rt = tp.run(to, out_dir=str(tmp_path / "t"), device="cpu", **kw)
    oj, ot = rj.infercnv_obj, rt.infercnv_obj
    assert ot.expr.shape == oj.expr.shape and ot.gene_order.names == oj.gene_order.names
    if step <= 3:
        np.testing.assert_array_equal(ot.expr, oj.expr)
    else:
        np.testing.assert_allclose(ot.expr, oj.expr, **TOL)
        for g, subs in oj.tumor_subclusters["subclusters"].items():
            assert list(ot.tumor_subclusters["subclusters"][g]) == list(subs)
    assert (rt.hmm_states is None) == (rj.hmm_states is None)
    if rj.hmm_states is not None:
        np.testing.assert_array_equal(rt.hmm_states, rj.hmm_states)


#: the options refused until the op-by-op steps 4-14, the DE mask of step 21
#: (ROADMAP A5), the Leiden, random_trees and per-chromosome partitions (A6)
#: and the plots (A7.3) were ported, each now run against the reference
FORMERLY_REFUSED = [
    dict(no_plot=False),
    dict(HMM=True, diagnostics=True),
    dict(plot_steps=True),
    dict(mask_nonDE_genes=True),
    dict(use_engine=False),
    dict(up_to_step=9),
    dict(scale_data=True),
    dict(max_centered_threshold="auto"),
    dict(analysis_mode="subclusters"),          # leiden by default
    dict(analysis_mode="subclusters", tumor_subcluster_partition_method="random_trees"),
    dict(analysis_mode="subclusters", per_chr_hmm_subclusters=True),
]


@pytest.mark.parametrize("kw", FORMERLY_REFUSED, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_formerly_refused_options_match_the_reference(tmp_path, carried, monkeypatch, kw):
    from test_torch_pca_knn import jax_omega
    from infercnv_tpu_torch.subcluster import pca as tpca

    monkeypatch.setattr(tpca, "range_omega", jax_omega)
    args = {"analysis_mode": "samples", "HMM": True, "HMM_type": "i6", "k_nn": 8, **kw}
    rt, rj, dt, dj = _pair(tmp_path, dict(n_normal=12, n_tumor=12, del_factor=0.7,
                                          amp_factor=1.3), **args)
    if "up_to_step" in kw:
        np.testing.assert_allclose(rt.infercnv_obj.expr, rj.infercnv_obj.expr, **TOL)
        assert rt.hmm_states is None and rj.hmm_states is None
        assert rt.infercnv_obj.tumor_subclusters is None
        return
    _assert_same_run(rt, rj, dt, dj)
    for g, subs in rj.infercnv_obj.tumor_subclusters["subclusters"].items():
        assert list(rt.infercnv_obj.tumor_subclusters["subclusters"][g]) == list(subs)


@pytest.fixture
def standin(monkeypatch):
    """One deterministic sampler in both packages (torch_port_util)."""
    monkeypatch.setattr(jbayes, "_gibbs_all_regions", standin_gibbs)
    monkeypatch.setattr(tbayes, "_gibbs_all_regions", standin_gibbs)


def _bayes_files(d):
    return sorted(f for f in os.listdir(d) if f.startswith("HMM_CNV_predictions")
                  or f.startswith("BayesNetOutput"))


def _assert_same_files(dt, dj, names):
    """Files (and the files of directories) of two out_dirs byte-equal."""
    for f in names:
        paths = [f]
        if os.path.isdir(os.path.join(dj, f)):
            paths = [os.path.join(f, g) for g in sorted(os.listdir(os.path.join(dj, f)))]
        for p in paths:
            assert filecmp.cmp(os.path.join(dt, p), os.path.join(dj, p), shallow=False), p


#: step 17's region reports are made by qnorm subclusters or by samples
BAYES_MODES = {
    "samples": dict(analysis_mode="samples", HMM_report_by="consensus"),
    "qnorm": dict(analysis_mode="subclusters", tumor_subcluster_partition_method="qnorm"),
}


@pytest.mark.parametrize("sampler", ["standin", "real"])
@pytest.mark.parametrize("mode", list(BAYES_MODES))
def test_bayes_filter_matches_the_reference(tmp_path, carried, request, mode, sampler):
    """run() at the reference's default BayesMaxPNormal=0.5 (refused until
    steps 18-19 were ported).  With one stand-in sampler in both packages
    the filtered states, the Pnorm_0.5 reports and CNV_State_Probabilities
    .dat are equal to the byte; with the real samplers (draws of different
    generators) the modelled regions are equal, their posteriors within
    0.05, and every region is decided alike (the planted CNVs are kept,
    P(normal) far from the threshold), so the filtered states are equal."""
    if sampler == "standin":
        request.getfixturevalue("standin")
    rt, rj, dt, dj = _pair(tmp_path, dict(del_factor=0.6, amp_factor=1.6), HMM=True,
                           HMM_type="i6", BayesMaxPNormal=0.5, **BAYES_MODES[mode])
    _assert_same_run(rt, rj, dt, dj)
    bt, bj = rt.bayes_result, rj.bayes_result
    assert bt.cnv_region_names == bj.cnv_region_names and bt.cnv_region_names
    assert bt.removed_regions == bj.removed_regions
    assert bt.reassigned == bj.reassigned
    names = _bayes_files(dj)
    assert len(names) == 5 and names == _bayes_files(dt)
    if sampler == "standin":
        _assert_same_files(dt, dj, names)
        np.testing.assert_array_equal(bt.cnv_state_probabilities,
                                      bj.cnv_state_probabilities)
    else:
        _assert_same_files(dt, dj, [f for f in names if f.startswith("HMM_CNV")])
        pt, pj = bt.cnv_state_probabilities, bj.cnv_state_probabilities
        np.testing.assert_allclose(pt, pj, atol=0.05)
        assert (np.abs(pj[2] - 0.5) > 0.2).all()       # decisive
    assert len(rt.region_reports) == len(rj.region_reports)


def test_save_rds_matches_the_reference(tmp_path, carried, standin):
    """save_rds=True (refused until the checkpoints and RDS were ported)
    with the Bayesian filter: the same checkpoint files as the reference's,
    each holding the same object (expr within 2e-5) and states, and the
    same final RDS object."""
    rt, rj, dt, dj = _pair(tmp_path, HMM=True, HMM_type="i6", save_rds=True,
                           BayesMaxPNormal=0.5, **BAYES_MODES["samples"])
    _assert_same_run(rt, rj, dt, dj)
    ckpts = sorted(f for f in os.listdir(dj) if f.endswith(".npz"))
    assert ckpts == sorted(f for f in os.listdir(dt) if f.endswith(".npz"))
    assert {"14_invert_log_transform.HMMi6.infercnv_obj.npz",
            "17_HMM_pred.HMMi6.infercnv_obj.npz",
            "19_HMM_pred.repr_intensitiesfiltered.HMMi6.infercnv_obj.npz",
            "preliminary.infercnv_obj.npz", "run.final.infercnv_obj.npz"} <= set(ckpts)
    for f in ckpts:
        ot, at, st = tckpt.load_step(os.path.join(dt, f))
        oj, aj, sj = tckpt.load_step(os.path.join(dj, f))
        assert at == aj, f
        np.testing.assert_allclose(ot.expr, oj.expr, err_msg=f, **TOL)
        assert (st is None) == (sj is None), f
        if st is not None:
            np.testing.assert_array_equal(st, sj)
    ft = t_read_rds(os.path.join(dt, "run.final.infercnv_obj"))
    fj = j_read_rds(os.path.join(dj, "run.final.infercnv_obj"))
    np.testing.assert_allclose(ft.expr, fj.expr, **TOL)
    np.testing.assert_allclose(ft.expr, rt.infercnv_obj.expr, rtol=0, atol=1e-6)
    assert ft.cell_names == fj.cell_names and ft.options == fj.options


#: run() with its plots: (mode, options), each at no_plot=False with the
#: Bayesian filter; the qnorm run draws the subcluster plot too, and one
#: run draws every step's heatmap (op by op)
PLOT_RUNS = {
    "samples": dict(BAYES_MODES["samples"]),
    "qnorm": dict(BAYES_MODES["qnorm"], diagnostics=True),
    "plot_steps": dict(BAYES_MODES["samples"], plot_steps=True),
}


@pytest.mark.parametrize("mode", list(PLOT_RUNS))
def test_run_with_plots_matches_the_reference(tmp_path, carried, standin, mode):
    """run() at no_plot=False, HMM=True, BayesMaxPNormal=0.5 (the plots
    were refused until they were ported), one stand-in sampler in both
    packages: the same output files, every text output byte-equal (the
    heatmaps' groupings and thresholds, the reports, the Bayes files, the
    MCMC diagnostics), each PNG's 24x24 block fingerprint within 0.02.
    The op-by-op steps' matrices differ from the reference's within the
    2e-5 their results are held to, and so do the 1%/99% ranges drawn
    from them: with plot_steps the heatmaps' thresholds are held within
    that tolerance, every other text output byte-equal."""
    obj_kw = dict(n_normal=12, n_tumor=12, del_factor=0.6, amp_factor=1.6)
    rt, rj, dt, dj = _pair(tmp_path, obj_kw, HMM=True, HMM_type="i6",
                           no_plot=False, BayesMaxPNormal=0.5, png_res=40,
                           **PLOT_RUNS[mode])
    _assert_same_run(rt, rj, dt, dj)
    numeric = (".heatmap_thresholds.txt",) if mode == "plot_steps" else ()
    names = assert_same_outputs(dt, dj, numeric=numeric, tol=TOL["rtol"])
    pngs = {f for f in names if f.endswith(".png")}
    assert {"infercnv.preliminary.png", "infercnv.png",
            "infercnv.NormalProbabilities.PostFiltering.png"} <= pngs
    assert any(f.startswith("infercnv.17_HMM_pred") for f in pngs)
    assert any(f.startswith("infercnv.20_HMM_pred") for f in pngs)
    if mode == "qnorm":
        assert "infercnv_subclusters.png" in pngs
        assert any(f.endswith("MCMC_Diagnostics.txt") for f in names)
    if mode == "plot_steps":
        assert {"infercnv.04_logtransformed.png", "infercnv.14_invert_log_transform.png"} <= pngs
    steps = {r["step"] for r in rt.timer.records}
    assert {"15_prelim_plot.data", "15_prelim_plot.render", "17_state_plot",
            "18_bayes_plots.data", "20_proxy_plot.data", "23_final_plot.render"} <= steps
