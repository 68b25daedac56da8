"""The port's run() (device="cpu") against the JAX package's run() on
tests/test_pipeline.py's synthetic object (a planted loss on chr2 and gain
on chr3 in the tumour cells).

Same results: the final expr within rtol = atol = 2e-5, the HMM states
equal, and the 17_HMM_pred region reports byte-equal.  The i3 HMM draws
nothing; for i6 the port's build_hspike and cnv_mean_sd_trend_fit are
replaced by the reference's hspike and trend fits, carried across, since
the two packages draw different random bits (their draws are held to their
distribution in tests/test_torch_hspike.py), and so is the reference's PCA
range-finder draw for the Leiden partition.  Options whose modules are not
ported raise NotImplementedError naming their ROADMAP item, before any
work; the options that were refused until the op-by-op steps, the DE mask
and the Leiden, random_trees and per-chromosome partitions were ported run
against the reference (test_formerly_refused_options_match_the_reference;
tests/test_torch_pipeline_ops.py holds them in more depth)."""

import filecmp
import os

import numpy as np
import pytest

import infercnv_tpu.runner.pipeline as jp
import infercnv_tpu_torch.runner.pipeline as tp
from infercnv_tpu_torch.interop import infercnv_from_numpy, trend_fits_from_numpy

from test_pipeline import make_synthetic

KW = dict(window_length=21, no_plot=True, BayesMaxPNormal=0, save_rds=False,
          denoise=True)
TOL = dict(rtol=2e-5, atol=2e-5)


def _assert_same_run(rt, rj, dt, dj):
    np.testing.assert_allclose(rt.infercnv_obj.expr, rj.infercnv_obj.expr, **TOL)
    np.testing.assert_array_equal(rt.hmm_states, rj.hmm_states)
    np.testing.assert_array_equal(rt.hmm_proxy_values, rj.hmm_proxy_values)
    reports = sorted(f for f in os.listdir(dj) if f.startswith("17_HMM_pred"))
    assert len(reports) == 4
    assert reports == sorted(f for f in os.listdir(dt) if f.startswith("17_HMM_pred"))
    for f in reports:
        assert filecmp.cmp(os.path.join(dt, f), os.path.join(dj, f), shallow=False), f


def _pair(tmp_path, obj_kw=None, **kw):
    jo = make_synthetic(**(obj_kw or {}))
    to = infercnv_from_numpy(vars(jo))
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    rj = jp.run(jo, out_dir=dj, **KW, **kw)
    rt = tp.run(to, out_dir=dt, device="cpu", **KW, **kw)
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


REFUSED = [
    (dict(save_rds=True), "A7"),
    (dict(no_plot=False), "A7"),
    (dict(HMM=True, BayesMaxPNormal=0.5), "A7"),
    (dict(plot_steps=True), "A7"),
    (dict(n_devices=2), "A8"),
    (dict(HMM=True, sim_method="splatter"), "A9"),
]


@pytest.mark.parametrize("kw,item", REFUSED)
def test_unported_options_are_refused_before_any_work(tmp_path, kw, item):
    args = {**KW, "analysis_mode": "samples", **kw}
    out = tmp_path / "never"
    obj = infercnv_from_numpy(vars(make_synthetic(n_normal=4, n_tumor=4, genes_per_chr=10)))
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tp.run(obj, out_dir=str(out), device="cpu", **args)
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
#: (ROADMAP A5) and the Leiden, random_trees and per-chromosome partitions
#: (A6) were ported, each now run against the reference
FORMERLY_REFUSED = [
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
    from torch_port_util import one_thread_a_pool
    from infercnv_tpu_torch.subcluster import pca as tpca

    monkeypatch.setattr(tpca, "range_omega", jax_omega)
    args = {"analysis_mode": "samples", "HMM": True, "HMM_type": "i6", "k_nn": 8, **kw}
    with one_thread_a_pool():
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
