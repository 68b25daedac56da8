"""TPU kernels 4-7 and the i3 Viterbi in the port, on the CPU (their plain
PyTorch versions), against the JAX package's functions on the same numpy
inputs: the Pallas kernels interpreted (interpret=True) and their XLA
counterparts.

Tolerances: medians bit-exact; the general-band smooth and the
median-centred tail rtol = atol = 2e-5 (residual tolerance,
tests/test_kernels_pallas.py:187-292); the bf16 smooth 1e-5 relative (atol
1e-6) against the reference's bf16 kernel, whose products are the same exact
products of bf16 values, and against the f32 smooth within the rounding
bound of its operands: bf16 keeps 8 significant bits, so each of the two
roundings moves a product by at most u = 2^-8 of it, and
|bf16 - f32| <= (2u + u^2) * sum|w||x| (+1e-6 for the f32 sums); Viterbi
states equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from infercnv_tpu.ops import layout as jlayout
from infercnv_tpu.ops.median import median_center_residual_pallas, row_median_pallas
from infercnv_tpu.ops.median import row_median as jax_row_median
from infercnv_tpu.ops.residual_fused import residual_fused_pallas
from infercnv_tpu.ops.smoothing import (_apply_banded, _apply_banded_pallas_k256,
                                        _apply_banded_pallas_sides)
from infercnv_tpu.ops.viterbi_pallas import viterbi_pallas
from infercnv_tpu.core.genome import GeneOrder as JaxGeneOrder
from infercnv_tpu_torch.core.genome import GeneOrder
from infercnv_tpu_torch.ops import layout as tlayout
from infercnv_tpu_torch.ops import median as tmed
from infercnv_tpu_torch.ops import residual_fused as tres
from infercnv_tpu_torch.ops import smoothing as tsmooth
from infercnv_tpu_torch.ops import viterbi_kernel as tvit

from torch_port_util import gene_orders, median_cases

MEDIAN_CASES = median_cases()
#: 650 genes 1 kbp apart: an 80 kbp window gives halfband > 128 (2 side tiles)
COORD_LENS, COORD_WINDOW = [300, 200, 150], 80_000


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _gapped_fields():
    """Genes 10 kbp apart, 2 kbp long, on 3 chromosomes; every 7th gene is
    400 kbp long, so it falls out of its neighbours' windows and their
    window sets have gaps (infercnv_tpu/ops/layout.py:220-229)."""
    lens = [60, 45, 30]
    G = sum(lens)
    start = np.arange(G, dtype=np.int64) * 10_000
    stop = start + 2_000
    stop[::7] += 398_000
    return dict(names=tuple(f"g{i}" for i in range(G)),
                chr_names=("chr1", "chr2", "chr3"),
                chr_ids=np.repeat(np.arange(3), lens).astype(np.int32),
                start=start, stop=stop)


@pytest.mark.parametrize("window", [30_000, 120_000])
def test_coordinate_operator_gapped_window_equal(window):
    f = _gapped_fields()
    jgo, tgo = JaxGeneOrder(**f), GeneOrder(**f)
    mid = (tgo.start + tgo.stop) / 2.0
    b, e = tgo.chr_ranges()[0]
    inside = np.nonzero((tgo.start[b:e] > mid[13] - window)
                        & (tgo.stop[b:e] < mid[13] + window))[0]
    assert (np.diff(inside) > 1).any()          # gene 13's window has a gap
    jop = jlayout.coordinate_smoothing_operator(jgo, window)
    top = tlayout.coordinate_smoothing_operator(tgo, window)
    assert top.halfband == jop.halfband and top.side_tiles == jop.side_tiles
    np.testing.assert_array_equal(top.blocks, jop.blocks)
    x = np.random.default_rng(1).normal(size=(3, tgo.num_genes))
    np.testing.assert_array_equal(top.apply_np(x), jop.apply_np(x))


def _coord_ops():
    jgo, tgo = gene_orders(COORD_LENS)
    return (jgo, tgo, jlayout.coordinate_smoothing_operator(jgo, COORD_WINDOW),
            tlayout.coordinate_smoothing_operator(tgo, COORD_WINDOW))


@pytest.mark.parametrize("kind", ["coordinates", "pyramidal"])
def test_general_smooth_matches_reference(kind):
    if kind == "coordinates":
        jgo, tgo, jop, top = _coord_ops()
        assert jop.side_tiles == 2 and jop.halfband > 128
    else:
        jgo, tgo = gene_orders([400, 250, 60, 1])
        jop = jlayout.smoothing_operator(jgo, 101)
        top = tlayout.smoothing_operator(tgo, 101)
    x = np.random.default_rng(4).normal(size=(24, jgo.num_genes)).astype(np.float32)
    w = tsmooth.BandWeights.from_operator(top, "cpu")
    before = tsmooth.LAUNCHES_GENERAL
    got = tsmooth.apply_banded_general(torch.from_numpy(x), w).numpy()
    assert tsmooth.LAUNCHES_GENERAL == before    # the CPU takes the plain version
    want_pallas = np.asarray(_apply_banded_pallas_sides(
        x, jnp.asarray(jop.blocks), jop.n_tiles, jop.side_tiles, jop.num_genes,
        True))
    want_xla = np.asarray(_apply_banded(
        jnp.asarray(x), jnp.asarray(jop.blocks), jop.n_tiles, jop.side_tiles,
        jop.num_genes))
    np.testing.assert_allclose(got, want_pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want_xla, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind,chunk", [("coordinates", 256), ("coordinates", 8),
                                        ("pyramidal", 256)])
def test_general_kernel_taps(kind, chunk):
    """The operands of csrc/smooth_general.cu (band4 and each gene tile's
    nonzero taps [tap_lo, tap_hi)), applied as the kernel applies them (the
    taps staged in chunks, each chunk's x at the offset of its first tap),
    reproduce the smooth, and no tap outside a tile's range has a weight:
    the layout the card reads is checked here, where the kernel cannot run."""
    if kind == "coordinates":
        _, tgo, _, top = _coord_ops()
    else:
        _, tgo = gene_orders([300, 150, 80, 41, 1, 2])
        top = tlayout.smoothing_operator(tgo, 101)
    w = tsmooth.BandWeights.from_operator(top, "cpu")
    band4 = w.band4.numpy()
    lo, hi = w.tap_lo.numpy(), w.tap_hi.numpy()
    G, t4, TG = tgo.num_genes, w.halfband4, tsmooth.GENERAL_TILE
    assert (lo % 4 == 0).all() and (hi % 4 == 0).all() and (hi >= lo).all()
    assert w.max_span == int((hi - lo).max())
    x = np.random.default_rng(5).normal(size=(4, G)).astype(np.float32)
    xp = np.zeros((4, band4.shape[1] + 2 * t4 + 4), np.float32)
    xp[:, t4:t4 + G] = x
    y = np.zeros((4, band4.shape[1]), np.float64)
    for j in range(lo.shape[0]):
        cols = slice(j * TG, min((j + 1) * TG, band4.shape[1]))
        outside = np.ones(band4.shape[0], bool)
        outside[lo[j]:hi[j]] = False
        assert not band4[outside, cols].any()
        g = np.arange(cols.start, cols.stop)
        for c0 in range(lo[j], hi[j], chunk):
            staged = xp[:, j * TG + c0:]        # column c holds x[g0 + c0 - t4 + c]
            for e in range(c0, min(c0 + chunk, hi[j])):
                y[:, g] += band4[e, g] * staged[:, g - j * TG + e - c0]
    want = tsmooth.apply_banded_plain(torch.from_numpy(x), w).numpy()
    np.testing.assert_allclose(y[:, :G], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(MEDIAN_CASES))
def test_row_median_matches_pallas(name):
    x = MEDIAN_CASES[name]
    before = tmed.LAUNCHES
    got = tmed.row_median(torch.from_numpy(x)).numpy()
    assert tmed.LAUNCHES == before
    want = np.asarray(row_median_pallas(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(tmed.row_median_plain(
        torch.from_numpy(x)).numpy()))


@pytest.mark.parametrize("G", [300, 301])
def test_median_center_residual_matches_pallas(G):
    """The tail on a padded smooth output (tests/test_kernels_pallas.py:130-154),
    odd and even widths, with ties in some rows."""
    rng = np.random.default_rng(G)
    C, Gp = 24, 384
    yp = np.zeros((C, Gp), np.float32)
    yp[:, :G] = rng.normal(0, 0.5, (C, G)).astype(np.float32)
    yp[:4, :G] = np.round(yp[:4, :G] * 4) / 4
    gmin = rng.normal(-0.1, 0.02, G).astype(np.float32)
    gmax = rng.normal(0.1, 0.02, G).astype(np.float32)
    want = np.asarray(median_center_residual_pallas(
        yp, gmin, gmax, G, interpret=True))[:, :G]
    before = tmed.LAUNCHES_EPILOGUE
    got, med = tmed.median_center_residual(
        torch.from_numpy(yp), torch.from_numpy(gmin), torch.from_numpy(gmax), G,
        with_median=True)
    assert tmed.LAUNCHES_EPILOGUE == before
    assert got.shape == (C, G)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(_bits(med.numpy()),
                                  _bits(jax_row_median(jnp.asarray(yp[:, :G]))))


@pytest.mark.parametrize("lens,window", [([150, 150], 51),
                                         ([300, 150, 80, 41, 1, 2], 101)])
def test_bf16_smooth_matches_pallas(lens, window):
    jgo, tgo = gene_orders(lens)
    jop = jlayout.smoothing_operator(jgo, window)
    top = tlayout.smoothing_operator(tgo, window)
    x = np.random.default_rng(0).normal(0, 1, (16, jgo.num_genes)).astype(np.float32)
    wb = tsmooth.BandWeights.from_operator(top, "cpu", bf16=True)
    wf = tsmooth.BandWeights.from_operator(top, "cpu")
    before = tsmooth.LAUNCHES_BF16
    got = tsmooth.apply_banded(torch.from_numpy(x), wb).numpy()
    assert tsmooth.LAUNCHES_BF16 == before
    want = np.asarray(_apply_banded_pallas_k256(
        x, jnp.asarray(jop.shifted_blocks()), jop.n_tiles, jop.side_tiles,
        jop.num_genes, True, matmul_dtype="bfloat16"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    f32 = tsmooth.apply_banded(torch.from_numpy(x), wf).numpy()
    scale = tsmooth.apply_banded(torch.from_numpy(np.abs(x)), wf).numpy()
    assert (np.abs(got - f32) <= (2.0 ** -7 + 2.0 ** -16) * scale + 1e-6).all()
    assert not np.array_equal(got, f32)


@pytest.mark.parametrize("center", ["median", "mean"])
def test_residual_bf16_matches_pallas(center):
    """The fused residual with the reference kernel's bf16 flag."""
    jgo, tgo = gene_orders([200, 90, 51])
    G = jgo.num_genes
    rng = np.random.default_rng(8)
    counts = rng.poisson(rng.gamma(2.0, 30.0, G)[None, :], (40, G)).astype(np.uint16)
    nf = float(np.median(counts.sum(axis=1, dtype=np.float64)))
    ml = rng.normal(0, 0.1, (2, G)).astype(np.float32)
    mr = rng.normal(0, 0.05, (2, G)).astype(np.float32)
    b = [ml.min(0), ml.max(0), mr.min(0), mr.max(0)]
    jop = jlayout.smoothing_operator(jgo, 101)
    want = np.asarray(residual_fused_pallas(
        counts, jop.stacked_blocks(), *b, nf, jop.n_tiles, G,
        center_mean=(center == "mean"), matmul_dtype="bfloat16", interpret=True))
    wb = tsmooth.BandWeights.from_operator(tlayout.smoothing_operator(tgo, 101),
                                           "cpu", bf16=True)
    tb = [torch.from_numpy(np.ascontiguousarray(v)) for v in b]
    before = (tres.LAUNCHES, tres.LAUNCHES_BF16)
    got = tres.residual_fused(torch.from_numpy(counts), wb, *tb, nf,
                              center_mean=(center == "mean"))
    assert (tres.LAUNCHES, tres.LAUNCHES_BF16) == before
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    narrow = tres.residual_fused(torch.from_numpy(counts), wb, *tb, nf,
                                 center_mean=(center == "mean"),
                                 out_dtype=torch.float16)
    assert torch.equal(narrow, got.to(torch.float16))


def test_viterbi_three_states_matches_pallas():
    """The i3 model (S = 3) through the plain Viterbi and the reference's
    interpreted kernel, with chain restarts and short sequences."""
    rng = np.random.default_rng(12)
    B, L = 192, 150
    means = np.array([0.8, 1.0, 1.2])
    x = rng.normal(1.0, 0.12, (B, L)).astype(np.float32)
    x[10:60, 20:70] += 0.25
    x[80:120, 90:140] -= 0.22
    lengths = np.full(B, L, np.int32)
    lengths[130:160] = rng.integers(1, L, 30)
    bnd = np.zeros((B, L), np.int8)
    bnd[:, [0, 60, 110]] = 1
    bnd[np.arange(L)[None, :] >= lengths[:, None]] = 0
    sigma = rng.uniform(0.08, 0.15, B).astype(np.float32)
    want = np.asarray(viterbi_pallas(x, lengths, sigma, means, t=1e-6,
                                     boundaries=bnd, interpret=True))
    log_diag, log_off, log_delta = tvit.transition_logs(3, 1e-6)
    got = tvit.viterbi(torch.from_numpy(x), torch.from_numpy(lengths),
                       torch.from_numpy(sigma), torch.from_numpy(bnd),
                       means, log_delta, log_diag, log_off).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {1, 2, 3}


def test_row_kernel_capacity():
    """The one-row kernels' shared memory, mirrored from the CUDA sources:
    the bench genome fits the fused kernel on an H100 (227 KB a block), a
    60,000-gene genome fits neither one-row kernel."""
    from infercnv_tpu_torch.parallel.engine import SMEM_OPTIN_BYTES
    from torch_port_util import realistic_sizes

    _, tgo = gene_orders(list(realistic_sizes()))
    w = tsmooth.BandWeights.from_operator(tlayout.smoothing_operator(tgo, 101), "cpu")
    assert tres.fits(w, SMEM_OPTIN_BYTES) and w.row_kernel_fits(SMEM_OPTIN_BYTES)
    # 8448 f32 (33 KB) + pads + common column + edge buffer + select
    assert 33_792 < w.row_smem_bytes() < 50_000
    _, wide = gene_orders([60_000 // 22] * 21 + [60_000 - 21 * (60_000 // 22)])
    ww = tsmooth.BandWeights.from_operator(tlayout.smoothing_operator(wide, 101), "cpu")
    assert not tres.fits(ww, SMEM_OPTIN_BYTES)
    assert not ww.row_kernel_fits(SMEM_OPTIN_BYTES)
