"""The splatter simulation (sim/splatter.py) and the splatter branches of
the hspike and sim_foreground: the port (torch.Generator sub-streams)
against the JAX package (jax.random).

The estimated parameters are host numpy and scipy, and equal.  The draws
differ in their bits, so they are held to their distribution as
tests/test_torch_hspike.py holds the other simulators: per-gene means of
the port's counts within 5 standard errors of the JAX simulation's, zero
fractions within 5 binomial standard deviations (plus 1/n), with the
draws that are made once a gene held still: outliers off and the BCV
chi-square's degrees of freedom at 1e6 (its factor sqrt(df / chi) within
0.2% of 1), since one such draw moves a whole gene's counts in one package
and not in the other.  Those draws are held to their own distributions
instead: the outliers' share of genes to its binomial, the chi-square's
mean and variance.  The same seed gives the same counts.  For run() both
packages' simulate_splatter_counts are replaced by one deterministic
stand-in and the reference's hspike and trend fits are carried across
(test_torch_pipeline.carried), so the states and reports are compared
exactly."""

import dataclasses
import filecmp
import os

import jax
import numpy as np
import pytest
import torch

import infercnv_tpu.runner.pipeline as jp
import infercnv_tpu.sim.splatter as jspl
import infercnv_tpu_torch.runner.pipeline as tp
import infercnv_tpu_torch.sim.splatter as tspl
from infercnv_tpu.models import hspike as jhs
from infercnv_tpu.ops.transforms import normalize_counts_by_seq_depth
from infercnv_tpu_torch.interop import infercnv_from_numpy
from infercnv_tpu_torch.models import hspike as ths

from test_pipeline import make_synthetic
from test_torch_hspike import _held_to
from test_torch_pipeline import KW, carried  # noqa: F401  (a fixture)
from torch_port_util import one_thread_a_pool


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_a_pool():
        yield


@pytest.fixture(scope="module")
def counts_gc():
    o = make_synthetic(seed=3, n_normal=20, n_tumor=20, genes_per_chr=50)
    return np.asarray(o.counts[o.all_ref_idx()]).T      # [G, normal cells]


def _fields(p):
    d = dataclasses.asdict(p)
    d.pop("dropout_spline")
    return d


def test_estimated_parameters_equal(counts_gc):
    t = tspl.estimate_splatter_params(counts_gc)
    j = jspl.estimate_splatter_params(counts_gc)
    assert _fields(t) == _fields(j)
    tx, ty = t.dropout_spline.dense_grid()
    jx, jy = j.dropout_spline.dense_grid()
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("variant", [
    dict(),
    dict(lib_norm=True, lib_loc=3000.0, lib_scale=400.0),
    dict(include_dropout=True),
    dict(include_dropout=True, use_spline_dropout_fit=True),
])
def test_draws_held_to_their_distribution(counts_gc, variant):
    p = tspl.estimate_splatter_params(counts_gc)
    p = dataclasses.replace(p, out_prob=0.0, bcv_df=1e6, **variant)
    jpar = jspl.SplatterParams(**{f.name: getattr(p, f.name)
                                  for f in dataclasses.fields(p)})
    means = np.concatenate([np.geomspace(0.05, 40.0, 40), [1e-3]])
    n = 3000
    t = tspl.simulate_splatter_counts(torch.Generator().manual_seed(11), p, means, n).numpy()
    j = np.asarray(jspl.simulate_splatter_counts(jax.random.PRNGKey(11), jpar, means, n))
    assert t.shape == j.shape == (n, means.size) and t.dtype == np.float32
    assert (t >= 0).all() and (t == np.round(t)).all()
    _held_to(t, j, n)


def test_gene_means_outliers_and_seeds(counts_gc):
    """Without gene means the base means are a gamma draw; outliers take a
    binomial share of the genes; one seed gives one matrix."""
    p = dataclasses.replace(tspl.estimate_splatter_params(counts_gc),
                            nGenes=4000, nCells=20, out_prob=0.1)
    a = tspl.simulate_splatter_counts(torch.Generator().manual_seed(5), p)
    b = tspl.simulate_splatter_counts(torch.Generator().manual_seed(5), p)
    c = tspl.simulate_splatter_counts(torch.Generator().manual_seed(6), p)
    assert a.shape == (20, 4000) and torch.equal(a, b) and not torch.equal(a, c)
    g = torch.Generator().manual_seed(7)
    subs = tspl._substreams(g, 7)
    sel = torch.bernoulli(torch.full((4000,), 0.1), generator=subs[1]) > 0
    share = sel.double().mean().item()
    assert abs(share - 0.1) <= 5 * np.sqrt(0.1 * 0.9 / 4000)
    # the chi-square of the BCV: 2 Gamma(df / 2) has mean df and variance 2 df
    chi = 2.0 * tspl.standard_gamma(subs[3], 30.0, (200_000,)).double()
    assert abs(chi.mean().item() - 60.0) <= 5 * np.sqrt(120.0 / 200_000)
    assert abs(chi.var().item() / 120.0 - 1.0) <= 0.03


def _standin(key_or_gen, params, gene_means=None, num_cells=None):
    """One deterministic stand-in for both packages' simulate_splatter_counts:
    counts from the gene means (rounded to 1e-4, so a last-bit difference
    between the packages' means does not move them) and a fixed uniform
    draw of the matrix's shape."""
    gm = np.round(np.asarray(gene_means, np.float64), 4)
    n = int(num_cells or params.nCells)
    u = np.random.default_rng(n * 7919 + gm.size).random((n, gm.size))
    return np.floor(gm[None, :] * 2.0 * u + 0.5).astype(np.float32)


@pytest.fixture
def standin(monkeypatch):
    monkeypatch.setattr(jspl, "simulate_splatter_counts", _standin)
    monkeypatch.setattr(tspl, "simulate_splatter_counts",
                        lambda *a, **k: torch.from_numpy(_standin(*a, **k)))


def test_hspike_splatter_branch(counts_gc, standin):
    """build_hspike(sim_method="splatter") estimates the parameters from the
    normal cells' counts and simulates 100 cells a block from them; with
    the stand-in its counts are the stand-in's on the port's own gene means
    (a draw of theirs), normalised as the reference's."""
    o = make_synthetic(seed=3, n_normal=20, n_tumor=20, genes_per_chr=50)
    o.expr = np.asarray(normalize_counts_by_seq_depth(o.expr))
    t = ths.build_hspike(infercnv_from_numpy(vars(o)), sim_method="splatter", seed=5)
    j = jhs.build_hspike(o, sim_method="splatter", seed=5)
    assert t.cell_names == j.cell_names and t.expr.shape == j.expr.shape
    assert list(t.ref_groups) == list(j.ref_groups)
    np.testing.assert_allclose(t.expr.sum(axis=1), j.expr.sum(axis=1), rtol=1e-4)


@pytest.mark.parametrize("sim_foreground", [False, True])
def test_splatter_run_matches_the_reference(tmp_path, carried, standin,  # noqa: F811
                                            sim_foreground):
    kw = dict(KW, HMM=True, HMM_type="i6", analysis_mode="samples",
              HMM_report_by="consensus", sim_method="splatter",
              sim_foreground=sim_foreground)
    jo = make_synthetic()
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    rj = jp.run(jo, out_dir=dj, **kw)
    rt = tp.run(infercnv_from_numpy(vars(jo)), out_dir=dt, device="cpu", **kw)
    np.testing.assert_allclose(rt.infercnv_obj.expr, rj.infercnv_obj.expr,
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(rt.hmm_states, rj.hmm_states)
    reports = sorted(f for f in os.listdir(dj)
                     if f.startswith("17_HMM_pred") and not f.endswith(".npz"))
    assert reports and reports == sorted(
        f for f in os.listdir(dt) if f.startswith("17_HMM_pred") and not f.endswith(".npz"))
    for f in reports:
        assert filecmp.cmp(os.path.join(dt, f), os.path.join(dj, f), shallow=False), f
