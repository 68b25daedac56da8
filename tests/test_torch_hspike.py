"""The hspike and its statistics: the port (a CPU torch.Generator) against
the JAX package (jax.random).

The two draw different bits, so the draws are held to their distribution:
per-gene means of the port's simulated counts within 5 standard errors of
the JAX simulation's, and per-gene zero fractions within 5 binomial
standard deviations (plus 1/n).  Everything that is not a draw is compared
exactly: the splines, the group statistics, the hspike's genome, names and
groups, and get_spike_dists on the reference's hspike carried across.  The
trend fit bootstraps, so it is held to the spread of the JAX fit over eight
seeds: within 5 of their standard deviations of their mean (0.02 at
least)."""

import jax
import numpy as np
import pytest
import torch

import infercnv_tpu.runner.pipeline as jp
from infercnv_tpu.models import hmm as jhmm
from infercnv_tpu.models import hspike as jhs
from infercnv_tpu.ops.transforms import normalize_counts_by_seq_depth
from infercnv_tpu.runner.config import RunConfig
from infercnv_tpu.sim import meanvar as jmv
from infercnv_tpu.utils import splines as jsp
from infercnv_tpu_torch.interop import infercnv_from_numpy
from infercnv_tpu_torch.models import hmm as thmm
from infercnv_tpu_torch.models import hspike as ths
from infercnv_tpu_torch.sim import meanvar as tmv
from infercnv_tpu_torch.utils import splines as tsp

from test_pipeline import make_synthetic
from torch_port_util import one_thread_a_pool


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test with one thread in torch's and the BLAS pools (see
    torch_port_util.one_thread_a_pool)."""
    with one_thread_a_pool():
        yield


@pytest.fixture(scope="module")
def obj():
    o = make_synthetic(seed=3, n_normal=20, n_tumor=20, genes_per_chr=50)
    o.expr = np.asarray(normalize_counts_by_seq_depth(o.expr))
    return o


@pytest.fixture(scope="module")
def spike(obj):
    """The reference's hspike, built and carried through the step 4-14
    chain as run() does (pipeline._hspike_residual_chain)."""
    h = jhs.build_hspike(obj, seed=5)
    jp._hspike_residual_chain(h, RunConfig(window_length=21), 3.0)
    return h


def test_splines_equal():
    rng = np.random.default_rng(1)
    for n in (3, 40, 900):
        x = rng.gamma(2.0, 2.0, n)
        y = np.log1p(x) + rng.normal(0, 0.1, n)
        t, j = tsp.fit_smoothing_spline(x, y), jsp.fit_smoothing_spline(x, y)
        np.testing.assert_array_equal(t.coef, j.coef)
        np.testing.assert_array_equal(t.knots, j.knots)
        q = np.linspace(-1, x.max() + 2, 57)
        np.testing.assert_array_equal(t.predict(q), j.predict(q))
        for a, b in zip(t.dense_grid(), j.dense_grid()):
            np.testing.assert_array_equal(a, b)


def test_group_statistics_equal(obj):
    groups = list(obj.obs_groups.values()) + list(obj.ref_groups.values())
    for nf in (None, 1234.5):
        (ta, tb), tl = tmv.group_stats_single_pass(obj.counts, [groups, groups[:1]],
                                                   chunk=7, normalize_factor=nf)
        (ja, jb), jl = jmv.group_stats_single_pass(obj.counts, [groups, groups[:1]],
                                                   chunk=7, normalize_factor=nf)
        np.testing.assert_array_equal(tl, jl)
        for t, j in zip(ta + tb, ja + jb):
            np.testing.assert_array_equal(t, j)
    for fn in ("get_mean_var_table", "get_mean_vs_p0_table"):
        for t, j in zip(getattr(tmv, fn)(obj.expr, groups), getattr(jmv, fn)(obj.expr, groups)):
            np.testing.assert_array_equal(t, j)
    m, v = jmv.get_mean_var_table(obj.expr, groups)
    np.testing.assert_array_equal(tmv.fit_mean_var_spline(m, v).coef,
                                  jmv.fit_mean_var_spline(m, v).coef)
    m0, p0 = jmv.get_mean_vs_p0_table(obj.expr, groups)
    np.testing.assert_array_equal(tmv.fit_dropout_spline(m0, p0).coef,
                                  jmv.fit_dropout_spline(m0, p0).coef)
    assert tmv.estimate_common_dispersion(obj.counts.T) == \
        jmv.estimate_common_dispersion(obj.counts.T)


def _held_to(t, j, n):
    """Per-gene means within 5 standard errors, zero fractions within 5
    binomial standard deviations (+ 1/n)."""
    se = np.sqrt((t.var(axis=0, ddof=1) + j.var(axis=0, ddof=1)) / n) + 1e-6
    assert (np.abs(t.mean(axis=0) - j.mean(axis=0)) <= 5 * se).all()
    pt, pj = (t == 0).mean(axis=0), (j == 0).mean(axis=0)
    p = (pt + pj) / 2
    assert (np.abs(pt - pj) <= 5 * np.sqrt(p * (1 - p) * 2 / n) + 1.0 / n).all()


@pytest.mark.parametrize("method", ["meanvar", "simple"])
def test_simulated_counts_held_to_their_distribution(obj, method):
    groups = list(obj.obs_groups.values()) + list(obj.ref_groups.values())
    m, v = jmv.get_mean_var_table(obj.expr, groups)
    mv = jmv.fit_mean_var_spline(m, v)
    m0, p0 = jmv.get_mean_vs_p0_table(obj.expr, groups)
    drop = jmv.fit_dropout_spline(m0, p0)
    means = np.concatenate([np.geomspace(0.05, 80.0, 60), [1e-3]])
    n = 3000
    gen = torch.Generator().manual_seed(11)
    key = jax.random.PRNGKey(11)
    if method == "meanvar":
        t = tmv.simulate_meanvar_counts(gen, means, mv, n, drop).numpy()
        j = np.asarray(jmv.simulate_meanvar_counts(key, means, mv, n, drop))
    else:
        t = tmv.simulate_simple_counts(gen, means, n, 0.1, drop).numpy()
        j = np.asarray(jmv.simulate_simple_counts(key, means, n, 0.1, drop))
    assert t.shape == j.shape == (n, means.size) and t.dtype == np.float32
    assert (t >= 0).all() and (t == np.round(t)).all()
    _held_to(t, j, n)


def test_standard_gamma_moments():
    gen = torch.Generator().manual_seed(2)
    for shape in (0.5, 1.0, 10.0):
        x = tmv.standard_gamma(gen, shape, (400, 250)).double().numpy()
        # mean and variance of Gamma(shape, 1) are both `shape`
        assert abs(x.mean() - shape) <= 5 * np.sqrt(shape / x.size)
        assert abs(x.var() - shape) <= 0.05 * shape


@pytest.mark.parametrize("sim_method", ["meanvar", "simple"])
def test_hspike_structure_equal(obj, sim_method):
    t = ths.build_hspike(infercnv_from_numpy(vars(obj)), sim_method=sim_method, seed=5)
    j = jhs.build_hspike(obj, sim_method=sim_method, seed=5)
    assert t.gene_order.names == j.gene_order.names
    assert t.gene_order.chr_names == j.gene_order.chr_names
    for f in ("chr_ids", "start", "stop"):
        np.testing.assert_array_equal(getattr(t.gene_order, f), getattr(j.gene_order, f))
    assert t.cell_names == j.cell_names
    assert list(t.ref_groups) == list(j.ref_groups)
    assert list(t.obs_groups) == list(j.obs_groups)
    assert t.expr.shape == j.expr.shape and t.expr.dtype == j.expr.dtype
    # depth-normalised to the normals' median library size, as the reference
    np.testing.assert_allclose(t.expr.sum(axis=1), j.expr.sum(axis=1), rtol=1e-4)
    # a CPU generator seeded from `seed`: the same hspike every time
    again = ths.build_hspike(infercnv_from_numpy(vars(obj)), sim_method=sim_method, seed=5)
    np.testing.assert_array_equal(again.expr, t.expr)


def test_hspike_refuses_splatter(obj):
    """Splatter was refused until it was ported (ROADMAP A9): it builds the
    reference's hspike layout now (tests/test_torch_splatter.py holds its
    draws), and an unknown sim_method is refused."""
    t = ths.build_hspike(infercnv_from_numpy(vars(obj)), sim_method="splatter", seed=5)
    j = jhs.build_hspike(obj, sim_method="meanvar", seed=5)
    assert t.gene_order.names == j.gene_order.names
    assert t.cell_names == j.cell_names and t.expr.shape == j.expr.shape
    assert np.isfinite(t.expr).all()
    with pytest.raises(ValueError, match="nope"):
        ths.build_hspike(infercnv_from_numpy(vars(obj)), sim_method="nope")


def test_spike_dists_equal_on_the_reference_hspike(spike):
    th = infercnv_from_numpy(vars(spike))
    t, j = thmm.gene_expr_by_cnv(th), jhmm.gene_expr_by_cnv(spike)
    assert list(t) == list(j)
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])
    assert thmm.get_spike_dists(th) == jhmm.get_spike_dists(spike)


def test_trend_fit_within_the_bootstrap_spread(spike):
    th = infercnv_from_numpy(vars(spike))
    jfits = [jhmm.cnv_mean_sd_trend_fit(spike, seed=s) for s in range(8)]
    got = thmm.cnv_mean_sd_trend_fit(th, seed=777)
    assert list(got) == list(jfits[0])
    for lvl in got:
        ref = np.array([f[lvl] for f in jfits])          # [seeds, 2]
        tol = np.maximum(5 * ref.std(axis=0, ddof=1), 0.02)
        assert (np.abs(np.array(got[lvl]) - ref.mean(axis=0)) <= tol).all(), lvl
    assert thmm.cnv_mean_sd_trend_fit(th, seed=3) == thmm.cnv_mean_sd_trend_fit(th, seed=3)
