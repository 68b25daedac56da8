"""The port's run() (device="cpu") against the JAX package's run() on the
configurations that leave the engine's fast path or take the Leiden
partition: the default Leiden subclusters, the per-chromosome subclusters
and HMM, the op-by-op steps 4-14 with each of their options, outlier
pruning (step 16), the non-DE mask (step 21) and every up_to_step of 4-14.

The object has planted subclones (its own CNV segments each) in two
tumour samples beside one reference sample.  Same results: the final expr
within rtol = atol = 2e-5, the subclusters equal, the HMM states equal and
the 17_HMM_pred region reports byte-equal.  Denoise moves values strictly
inside a band to its centre; a value that sits at the band's edge (within
the tolerance) may be moved by one package and kept by the other, and is
accepted there (chip_smoke.denoised_agree, the rule of the card-against-CPU
checks).  The per-chromosome Leiden of raw rows ('simple') takes the kNN
of the f32 Gram form |a|^2 + |b|^2 - 2 a.b in both packages; where the
two round a near-tie differently, a per-chromosome partition may differ,
and that is accepted only when every kNN entry that differs is within the
Gram form's rounding bound of the k-th neighbour's distance and the HMM
states and reports are still equal.  The two packages draw
different random bits, so the reference's hspike (as built at step 3), its
trend fits (step 17), its PCA range-finder draw and, for the permutation
DE test, its p-values are handed across; the draws themselves are held to
their distribution (tests/test_torch_hspike.py, and the permutation test
below).  Each JAX run is made once per configuration (module cache)."""

import contextlib
import filecmp
import os

import numpy as np
import pytest
import torch

import infercnv_tpu.ops.de_mask as jde
import infercnv_tpu.runner.pipeline as jp
import infercnv_tpu.subcluster.partition as jpart
import infercnv_tpu_torch.ops.de_mask as tde
import infercnv_tpu_torch.runner.pipeline as tp
from infercnv_tpu.core.object import create_infercnv_object
from infercnv_tpu_torch.interop import infercnv_from_numpy, trend_fits_from_numpy
from infercnv_tpu_torch.subcluster import partition as tpart
from infercnv_tpu_torch.subcluster import pca as tpca

from chip_smoke import denoised_agree
from test_torch_pca_knn import jax_omega
from torch_port_util import one_thread_a_pool


@pytest.fixture(autouse=True)
def _one_thread_a_pool():
    with one_thread_a_pool():
        yield

KW = dict(window_length=21, no_plot=True, BayesMaxPNormal=0, save_rds=False,
          denoise=True, HMM=True, HMM_type="i6")
TOL = dict(rtol=2e-5, atol=2e-5)


def make_clonal(seed=3, genes_per_chr=60, n_chr=4):
    """Counts [G, C]: 24 reference cells; sample tumA of three subclones
    (18, 16, 14 cells: a loss on chr2, a gain on chr3, a partial loss on
    chr4) and sample tumB of two (17, 15: a gain on chr1, a loss on chr3)."""
    rng = np.random.default_rng(seed)
    G = genes_per_chr * n_chr
    base = rng.gamma(2.0, 50.0, G)
    g = genes_per_chr
    clones = [("normal", 24, []),
              ("tumA", 18, [(g, 2 * g, 0.5)]),
              ("tumA", 16, [(2 * g, 3 * g, 2.0)]),
              ("tumA", 14, [(3 * g, 3 * g + g // 2, 0.5)]),
              ("tumB", 17, [(0, g, 2.0)]),
              ("tumB", 15, [(2 * g + 10, 3 * g, 0.5)])]
    cols, cells, ann = [], [], {}
    for name, n, cnvs in clones:
        lam = base.copy()
        for lo, hi, f in cnvs:
            lam[lo:hi] *= f
        cols.append(rng.poisson(lam[:, None], size=(G, n)))
        for _ in range(n):
            c = f"{name}_{len(cells)}"
            cells.append(c)
            ann[c] = name
    counts = np.concatenate(cols, axis=1).astype(np.float64)
    table = {f"g{i}": (f"chr{i // g + 1}", (i % g) * 1000 + 1, (i % g) * 1000 + 501)
             for i in range(G)}
    return create_infercnv_object(
        counts_matrix=counts, gene_names=[f"g{i}" for i in range(G)],
        cell_names=cells, annotations=ann, gene_order_table=table,
        chr_file_order=[f"chr{i + 1}" for i in range(n_chr)],
        ref_group_names=["normal"], chr_exclude=(),
        min_max_counts_per_cell=(1, np.inf))


#: (JAX result, out dir, captured hspike / fits / perm p-values) per config
_JAX_RUNS: dict = {}


def _key(kw):
    return tuple(sorted((k, repr(v)) for k, v in kw.items()))


def jax_run(tmp_root, **kw):
    """The reference's run() of one configuration, made once; captures the
    hspike it builds, its trend fits and its permutation-test p-values."""
    key = _key(kw)
    if key not in _JAX_RUNS:
        cap = {"perm": []}
        out = str(tmp_root / f"jax{len(_JAX_RUNS)}")
        build, fit, perm = jp.build_hspike, jp.hmm_mod.cnv_mean_sd_trend_fit, jde._perm_pvals

        def j_build(*a, **k):
            h = build(*a, **k)
            cap["hspike"] = infercnv_from_numpy(vars(h))   # a copy, as built
            return h

        def j_fit(*a, **k):
            cap["fits"] = fit(*a, **k)
            return cap["fits"]

        def j_perm(*a, **k):
            cap["perm"].append(perm(*a, **k))
            return cap["perm"][-1]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jp, "build_hspike", j_build)
            mp.setattr(jp.hmm_mod, "cnv_mean_sd_trend_fit", j_fit)
            mp.setattr(jde, "_perm_pvals", j_perm)
            res = jp.run(make_clonal(), out_dir=out, **{**KW, **kw})
        _JAX_RUNS[key] = (res, out, cap)
    return _JAX_RUNS[key]


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    return tmp_path_factory.mktemp("jax_runs")


def port_run(tmp_path, cap, **kw):
    """The port's run() with the reference's draws handed across."""
    perms = list(cap["perm"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpca, "range_omega", jax_omega)
        if "hspike" in cap:
            mp.setattr(tp, "build_hspike",
                       lambda *a, **k: infercnv_from_numpy(vars(cap["hspike"])))
        if "fits" in cap:
            mp.setattr(tp.hmm_mod, "cnv_mean_sd_trend_fit",
                       lambda *a, **k: trend_fits_from_numpy(cap["fits"]))
        mp.setattr(tde, "_perm_pvals", lambda *a, **k: perms.pop(0))
        out = str(tmp_path / "torch")
        res = tp.run(infercnv_from_numpy(vars(make_clonal())), out_dir=out,
                     device="cpu", **{**KW, **kw})
    return res, out


def assert_expr(got, want):
    """Within rtol = atol = 2e-5, except a value at denoise's band edge."""
    assert got.shape == want.shape
    ok, err, flips = denoised_agree(np.asarray(got), np.asarray(want), TOL["rtol"])
    assert ok, f"expr differs by {err} away from the denoise band's edge"
    assert flips <= 2


def assert_same(rt, rj, dt, dj, reports=True):
    ot, oj = rt.infercnv_obj, rj.infercnv_obj
    assert ot.gene_order.names == oj.gene_order.names
    assert_expr(ot.expr, oj.expr)
    assert list(ot.ref_groups) == list(oj.ref_groups)
    for g in oj.ref_groups:
        np.testing.assert_array_equal(ot.ref_groups[g], oj.ref_groups[g])
    ts, js = ot.tumor_subclusters, oj.tumor_subclusters
    assert (ts is None) == (js is None)
    if js is not None:
        assert list(ts["subclusters"]) == list(js["subclusters"])
        for g, subs in js["subclusters"].items():
            assert list(ts["subclusters"][g]) == list(subs), g
            for name, idx in subs.items():
                np.testing.assert_array_equal(ts["subclusters"][g][name], idx)
    if oj.hspike is not None:
        np.testing.assert_allclose(ot.hspike.expr, oj.hspike.expr, **TOL)
    assert (rt.hmm_states is None) == (rj.hmm_states is None)
    if rj.hmm_states is not None:
        np.testing.assert_array_equal(rt.hmm_states, rj.hmm_states)
    if reports:
        files = sorted(f for f in os.listdir(dj) if f.startswith("17_HMM_pred"))
        assert len(files) == 4
        assert files == sorted(f for f in os.listdir(dt) if f.startswith("17_HMM_pred"))
        for f in files:
            assert filecmp.cmp(os.path.join(dt, f), os.path.join(dj, f), shallow=False), f


def test_leiden_default_matches(tmp_path, tmp_root):
    """The reference's default analysis: Leiden (PCA, CPM, auto
    resolution) subclusters, the engine residual kept for step 15."""
    rj, dj, cap = jax_run(tmp_root)
    rt, dt = port_run(tmp_path, cap)
    assert_same(rt, rj, dt, dj)
    assert tpart.ROWS_FROM == "device_chunks"
    subs = rt.infercnv_obj.tumor_subclusters["subclusters"]
    assert len(subs["tumA"]) >= 3 and len(subs["tumB"]) >= 2
    steps = {r["step"] for r in rt.timer.records}
    assert {"15_subclusters.pca", "15_subclusters.knn", "15_subclusters.leiden"} <= steps


@contextlib.contextmanager
def knn_recorded(module, log):
    """Record (rows as float64, neighbours) of each knn_indices call that a
    partition module makes."""
    orig = module.knn_indices

    def wrapped(x, k, *a, **kw):
        nn = orig(x, k, *a, **kw)
        rows = x.numpy() if torch.is_tensor(x) else np.asarray(x)
        log.append((np.asarray(rows, np.float64), np.asarray(nn)))
        return nn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "knn_indices", wrapped)
        yield log


def knn_near_ties(log_t, log_j):
    """Every kNN entry in which the two packages differ, with whether it is
    a near-tie: its float64 distance within the f32 Gram form's rounding
    bound (2 G 2^-24 (|q|^2 + |j|^2), doubled) of the reference's k-th."""
    assert len(log_t) == len(log_j)
    out = []
    for (xt, nt), (xj, nj) in zip(log_t, log_j):
        assert xt.shape == xj.shape
        G = xj.shape[1]
        for q in np.nonzero((np.sort(nt, 1) != np.sort(nj, 1)).any(1))[0]:
            d = ((xj - xj[q]) ** 2).sum(1)
            sq = (xj ** 2).sum(1)
            kth = nj[q][np.argmax(d[nj[q]])]
            for c in set(nt[q].tolist()) ^ set(nj[q].tolist()):
                bound = 2 * (2 * G * 2.0 ** -24 * (sq[q] + max(sq[c], sq[kth])))
                out.append((int(q), int(c), abs(d[c] - d[kth]) <= bound))
    return out


@pytest.mark.parametrize("refs", [False, True])
def test_per_chromosome_subclusters_and_hmm_match(tmp_path, tmp_root, refs):
    kw = dict(per_chr_hmm_subclusters=True, per_chr_hmm_subclusters_references=refs)
    log_j, log_t = [], []
    with knn_recorded(jpart, log_j):
        _JAX_RUNS.pop(_key(kw), None)
        rj, dj, cap = jax_run(tmp_root, **kw)
    with knn_recorded(tpart, log_t):
        rt, dt = port_run(tmp_path, cap, **kw)
    assert_same(rt, rj, dt, dj)
    assert tpart.ROWS_FROM == "host"
    assert list(rt.subclusters_per_chr) == list(rj.subclusters_per_chr)
    same = all(
        list(rt.subclusters_per_chr[c]) == list(groups)
        and all(np.array_equal(rt.subclusters_per_chr[c][n], idx)
                for n, idx in groups.items())
        for c, groups in rj.subclusters_per_chr.items())
    if not same:
        ties = knn_near_ties(log_t, log_j)
        assert ties and all(t for _q, _c, t in ties), ties


OP_BY_OP = {
    "use_engine_false": dict(use_engine=False),
    "scale_data": dict(scale_data=True),
    "num_ref_groups": dict(num_ref_groups=2),
    "random_trees": dict(tumor_subcluster_partition_method="random_trees"),
    "auto_threshold": dict(max_centered_threshold="auto"),
    "no_threshold": dict(max_centered_threshold=None, use_engine=False),
    "chr_ends": dict(remove_genes_at_chr_ends=True),
    "prune_outliers": dict(prune_outliers=True),
    "prune_outliers_bounds": dict(prune_outliers=True, outlier_lower_bound=0.8,
                                  outlier_upper_bound=1.3),
    "coordinates_i3": dict(use_engine=False, smooth_method="coordinates",
                           HMM_type="i3", window_length=30_000,
                           analysis_mode="samples"),
    "runmeans_cells": dict(use_engine=False, smooth_method="runmeans",
                           analysis_mode="cells", HMM_report_by="cell"),
    "all_options": dict(use_engine=False, num_ref_groups=2,
                        tumor_subcluster_partition_method="random_trees",
                        max_centered_threshold="auto", remove_genes_at_chr_ends=True,
                        prune_outliers=True, mask_nonDE_genes=True),
}


@pytest.mark.parametrize("name", list(OP_BY_OP))
def test_op_by_op_path_matches(tmp_path, tmp_root, name):
    kw = OP_BY_OP[name]
    rj, dj, cap = jax_run(tmp_root, **kw)
    rt, dt = port_run(tmp_path, cap, **kw)
    assert_same(rt, rj, dt, dj)
    steps = {r["step"] for r in rt.timer.records}
    assert "04-14_engine_transform" not in steps and "10_smooth" in steps
    if name == "chr_ends":
        assert rt.infercnv_obj.num_genes < make_clonal().num_genes
    if name in ("num_ref_groups", "all_options"):
        assert list(rt.infercnv_obj.ref_groups) == ["refgrp-1", "refgrp-2"]


@pytest.mark.parametrize("test_use,policy", [("wilcoxon", "any"), ("t", "all"),
                                             ("perm", "most")])
def test_mask_non_de_genes_matches(tmp_path, tmp_root, test_use, policy):
    """Step 21: the Wilcoxon and t p-values are the reference's numpy
    (exact); the permutation test takes the reference's p-values."""
    kw = dict(mask_nonDE_genes=True, test_use=test_use, require_DE_all_normals=policy,
              mask_nonDE_pval=0.2)
    rj, dj, cap = jax_run(tmp_root, **kw)
    rt, dt = port_run(tmp_path, cap, **kw)
    assert_same(rt, rj, dt, dj)
    assert "21_mask_nonDE" in {r["step"] for r in rt.timer.records}


@pytest.mark.parametrize("step", range(4, 15))
def test_up_to_step_op_by_op_matches(tmp_path, tmp_root, step):
    kw = dict(up_to_step=step, num_ref_groups=2, remove_genes_at_chr_ends=True,
              max_centered_threshold="auto")
    rj, dj, cap = jax_run(tmp_root, **kw)
    rt, dt = port_run(tmp_path, cap, **kw)
    assert_same(rt, rj, dt, dj, reports=False)
    assert rt.hmm_states is None


def test_op_by_op_equals_the_engine_in_the_port(tmp_path):
    """The port's op-by-op residual against its own engine, within the
    reference's engine-vs-op-by-op tolerance
    (tests/test_engine_pipeline_unify.py:21-23)."""
    obj = infercnv_from_numpy(vars(make_clonal()))
    kw = dict(window_length=21, no_plot=True, BayesMaxPNormal=0, save_rds=False)
    ops = tp.run(obj, out_dir=str(tmp_path / "o"), device="cpu", use_engine=False,
                 up_to_step=14, **kw).infercnv_obj.expr
    eng = tp.run(obj, out_dir=str(tmp_path / "e"), device="cpu", analysis_mode="samples",
                 up_to_step=15, **kw).infercnv_obj.expr
    np.testing.assert_allclose(ops, eng, rtol=2e-4, atol=2e-4)


def test_use_engine_true_refuses_op_by_op_options(tmp_path):
    obj = infercnv_from_numpy(vars(make_clonal()))
    with pytest.raises(ValueError, match="use_engine=True"):
        tp.run(obj, out_dir=str(tmp_path), device="cpu", use_engine=True,
               scale_data=True, **KW)


def test_perm_pvalues_follow_the_reference_distribution():
    """The permutation test draws its permutations from a torch.Generator:
    each gene's p-value is within 5 standard errors of the reference's
    (two independent 999-permutation estimates of the same p), and the
    observed-statistic ties count as the reference counts them."""
    rng = np.random.default_rng(8)
    x1 = rng.normal(0, 1, (12, 300)).astype(np.float32)
    x2 = rng.normal(0, 1, (20, 300)).astype(np.float32)
    x2[:, :60] += np.linspace(0.2, 1.5, 60, dtype=np.float32)
    pj = jde._perm_pvals(x1, x2, seed=0)
    pt = tde._perm_pvals(x1, x2, seed=0, device="cpu")
    assert pt.shape == pj.shape and pt.dtype == np.float64
    p = (pj + pt) / 2
    se = np.sqrt(2 * p * (1 - p) / 1000) + 1e-3
    assert (np.abs(pt - pj) <= 5 * se).all()
    assert pt.min() >= 1 / 1000 and pt.max() <= 1.0
    np.testing.assert_array_equal(pt, tde._perm_pvals(x1, x2, seed=0, device="cpu"))
    assert not np.array_equal(pt, tde._perm_pvals(x1, x2, seed=1, device="cpu"))
    # identical groups: every permutation ties the observed statistic
    same = np.ones((5, 4), np.float32)
    np.testing.assert_array_equal(tde._perm_pvals(same, same, device="cpu"), 1.0)
    np.testing.assert_array_equal(jde._perm_pvals(same, same), 1.0)


def test_wilcoxon_t_and_bh_exact():
    rng = np.random.default_rng(4)
    x1 = rng.normal(0, 1, (9, 50)).astype(np.float32)
    x2 = rng.normal(0.3, 1.2, (14, 50)).astype(np.float32)
    np.testing.assert_array_equal(tde._wilcoxon_pvals(x1, x2), jde._wilcoxon_pvals(x1, x2))
    np.testing.assert_array_equal(tde._t_pvals(x1, x2), jde._t_pvals(x1, x2))
    p = rng.uniform(size=40)
    np.testing.assert_array_equal(tde.bh_adjust(p), jde.bh_adjust(p))
    assert torch.is_tensor(tde.perm_permutations(6, 3))
