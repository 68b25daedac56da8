"""Every function of the port's ops/transforms.py (device="cpu") against the
JAX package's on the same seeded numpy inputs, and the chromosome smooths.

Tolerances: rtol = atol = 2e-5 (the reference's residual tolerance) for the
float ops; exact for the index-returning filters, the host numpy paths
(the reference's own numpy) and the median centring (an exact median on
both sides); the smooths atol 1e-6 (f32 rounding of differently grouped
sums, tests/test_kernels_pallas.py:49-59)."""

import numpy as np
import pytest
import torch

from infercnv_tpu.ops import transforms as J
from infercnv_tpu.ops.smoothing import (
    smooth_by_chromosome as j_smooth,
    smooth_by_chromosome_coordinates as j_smooth_coords,
)
from infercnv_tpu_torch.ops import transforms as T
from infercnv_tpu_torch.ops.smoothing import (
    smooth_by_chromosome as t_smooth,
    smooth_by_chromosome_coordinates as t_smooth_coords,
)

from torch_port_util import gene_orders, np_

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    counts = rng.poisson(rng.gamma(2.0, 10.0, 150)[None, :],
                         size=(40, 150)).astype(np.float32)
    resid = rng.normal(0.0, 0.8, size=(40, 150)).astype(np.float32)
    return counts, resid


def _same(got, want, exact=False):
    got, want = np_(got), np_(want)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


UNARY = ["log2xplus1", "invert_log2xplus1", "invert_log2", "anscombe_transform",
         "add_pseudocount", "make_zero_NA", "normalize_by_upper_quartile",
         "scale_infercnv_expr", "mean_center_gene_expr"]


@pytest.mark.parametrize("name", UNARY)
def test_elementwise_and_reduction_ops(data, name):
    counts, resid = data
    x = counts if name in ("log2xplus1", "anscombe_transform", "make_zero_NA",
                           "normalize_by_upper_quartile") else resid
    got = getattr(T, name)(x, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    _same(got, getattr(J, name)(x))


@pytest.mark.parametrize("name", ["clear_noise", "depress_log_signal_midpt_val",
                                  "normalize_counts_by_seq_depth",
                                  "clear_noise_via_ref_mean_sd",
                                  "ref_mean_sd_bounds"])
def test_host_ops_stay_numpy(data, name):
    """Host numpy in, the reference's numpy out, exactly; a tensor input
    computes with torch within the tolerance."""
    counts, resid = data
    args = {"clear_noise": (resid, 0.3, 0.1),
            "depress_log_signal_midpt_val": (resid, 0.1, 0.4),
            "normalize_counts_by_seq_depth": (counts,),
            "clear_noise_via_ref_mean_sd": (resid, np.arange(8), 1.5),
            "ref_mean_sd_bounds": (resid, np.arange(8), 1.5)}[name]
    want = getattr(J, name)(*args)
    got = getattr(T, name)(*args)
    got_t = getattr(T, name)(torch.as_tensor(args[0]), *args[1:])
    if name == "ref_mean_sd_bounds":
        for g, gt, w in zip(got, got_t, want):
            assert g == w and g.dtype == w.dtype
            np.testing.assert_allclose(float(gt), float(w), rtol=2e-5)
        return
    assert isinstance(got, np.ndarray) and got.dtype == np.asarray(want).dtype
    _same(got, want, exact=True)
    _same(got_t, want)


def test_normalize_with_factor_and_inplace_denoise(data):
    counts, resid = data
    _same(T.normalize_counts_by_seq_depth(counts, 123.0),
          J.normalize_counts_by_seq_depth(counts, 123.0), exact=True)
    _same(T.normalize_counts_by_seq_depth(torch.as_tensor(counts)),
          J.normalize_counts_by_seq_depth(counts))
    a, b = resid.copy(), resid.copy()
    T.clear_noise_via_ref_mean_sd(a, np.arange(8), inplace=True)
    J.clear_noise_via_ref_mean_sd(b, np.arange(8), inplace=True)
    np.testing.assert_array_equal(a, b)
    assert T.clear_noise(resid, 0.0) is not None
    _same(T.clear_noise(resid, 0.0), resid, exact=True)


@pytest.mark.parametrize("inv_log", [False, True])
@pytest.mark.parametrize("use_bounds", [True, False])
def test_reference_subtraction(data, inv_log, use_bounds):
    _, resid = data
    M = T.group_onehot([np.arange(0, 6), np.arange(6, 14)], resid.shape[0])
    np.testing.assert_array_equal(
        M, J.group_onehot([np.arange(0, 6), np.arange(6, 14)], resid.shape[0]))
    tm = T.ref_group_gene_means(resid, M, inv_log=inv_log, device="cpu")
    jm = J.ref_group_gene_means(resid, M, inv_log=inv_log)
    _same(tm, jm)
    _same(T.subtract_ref_expr(resid, np_(jm), use_bounds, device="cpu"),
          J.subtract_ref_expr(resid, jm, use_bounds))


def test_clamp_centre_bounds_outliers(data):
    _, resid = data
    _same(T.apply_max_threshold_bounds(resid, 0.5, device="cpu"),
          J.apply_max_threshold_bounds(resid, 0.5))
    for method in ("median", "mean"):
        for x in (resid, resid[:, :149]):   # even and odd widths
            _same(T.center_cells(x, method, device="cpu"),
                  J.center_cells(x, method), exact=(method == "median"))
    for got, want in zip(T.get_average_bounds(resid, device="cpu"),
                         J.get_average_bounds(resid)):
        np.testing.assert_allclose(float(got), float(want), **TOL)
    _same(T.remove_outliers_norm(resid, device="cpu"), J.remove_outliers_norm(resid))
    _same(T.remove_outliers_norm(resid, lower_bound=-0.2, upper_bound=0.3, device="cpu"),
          J.remove_outliers_norm(resid, lower_bound=-0.2, upper_bound=0.3))
    with pytest.raises(ValueError):
        T.remove_outliers_norm(resid, out_method="other", device="cpu")
    _same(T.transform_to_reference_based_zscores(np.abs(resid), np.arange(10), device="cpu"),
          J.transform_to_reference_based_zscores(np.abs(resid), np.arange(10)))


def test_gene_filters_and_tails(data):
    counts, _ = data
    for cutoff in (1.0, 8.0):
        _same(T.below_min_mean_expr_cutoff(counts, cutoff),
              J.below_min_mean_expr_cutoff(counts, cutoff), exact=True)
    sparse = np.where(counts > 12, counts, 0)
    _same(T.genes_below_min_cells_ref(sparse, 3), J.genes_below_min_cells_ref(sparse, 3),
          exact=True)
    jgo, tgo = gene_orders([40, 5, 2, 60])
    for w in (3, 11, 101):
        _same(T.genes_at_chr_ends(tgo, w), J.genes_at_chr_ends(jgo, w), exact=True)
    _same(T.remove_tails_indices(np.arange(10), 6), J.remove_tails_indices(np.arange(10), 6),
          exact=True)


def test_tensor_input_keeps_its_device(data):
    _, resid = data
    x = torch.as_tensor(resid)
    assert T.invert_log2(x).device == x.device
    assert T.center_cells(x).device == x.device


@pytest.mark.parametrize("method,window", [("pyramidinal", 21), ("pyramidinal", 101),
                                           ("runmeans", 31)])
def test_smooth_by_chromosome(data, method, window):
    _, resid = data
    jgo, tgo = gene_orders([70, 3, 77])
    got = t_smooth(resid, tgo, window, method, device="cpu")
    assert got.shape == resid.shape
    np.testing.assert_allclose(np_(got), np_(j_smooth(resid, jgo, window, method)),
                               rtol=0, atol=1e-6)


def test_smooth_by_chromosome_coordinates(data):
    _, resid = data
    jgo, tgo = gene_orders([70, 3, 77])   # genes 1 kbp apart, 500 bp long
    for window in (5_000, 40_000):
        np.testing.assert_allclose(
            np_(t_smooth_coords(resid, tgo, window, device="cpu")),
            np_(j_smooth_coords(resid, jgo, window)), rtol=0, atol=1e-6)
