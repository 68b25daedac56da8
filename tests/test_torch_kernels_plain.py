"""Each kernel module of the port, on the CPU (its plain PyTorch version),
against the JAX package's function on the same numpy inputs: the Pallas
kernels interpreted (interpret=True) and their XLA counterparts.

Tolerances: medians and Viterbi states exact; smooth atol 1e-6 (f32
rounding of differently grouped sums, as tests/test_kernels_pallas.py:49-59);
residuals rtol = atol = 2e-5 (tests/test_kernels_pallas.py:187-292); f16/bf16
residuals exactly the cast of the port's own f32 residual."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from infercnv_tpu.ops import layout as jlayout
from infercnv_tpu.ops.median import row_median as jax_row_median
from infercnv_tpu.ops.residual_fused import residual_fused_pallas
from infercnv_tpu.ops.smoothing import _apply_banded, _apply_banded_pallas_k256
from infercnv_tpu.models.hmm import HMMParams as JaxHMMParams
from infercnv_tpu.ops.viterbi_pack import PackedLayout as JaxPackedLayout
from infercnv_tpu.ops.viterbi_pack import viterbi_packed as jax_viterbi_packed
from infercnv_tpu.ops.viterbi_pallas import _log_sf_std_normal, viterbi_pallas
from infercnv_tpu_torch.ops import layout as tlayout
from infercnv_tpu_torch.ops import residual_fused as tres
from infercnv_tpu_torch.ops import smoothing as tsmooth
from infercnv_tpu_torch.ops import viterbi_kernel as tvit
from infercnv_tpu_torch.ops.median import row_median
from infercnv_tpu_torch.ops.viterbi_pack import get_layout, viterbi_packed

from torch_port_util import (MEANS, MEANS_ROUND, SDS, SDS_ROUND, gene_orders,
                             median_cases, np_)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# --------------------------------------------------------------------------
# median
# --------------------------------------------------------------------------

MEDIAN_CASES = median_cases()


@pytest.mark.parametrize("name", sorted(MEDIAN_CASES))
def test_row_median_exact(name):
    x = MEDIAN_CASES[name]
    got = row_median(torch.from_numpy(x)).numpy()
    with np.errstate(invalid="ignore"):
        want = np.median(x, axis=1)
    np.testing.assert_array_equal(got, want)
    # bit-exact to the reference radix select (sign of zero included)
    ref = np.asarray(jax_row_median(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_torch_median_is_not_numpy_median():
    """Why the port never calls torch.median: it returns the lower middle."""
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    assert float(torch.median(x)) == 2.0
    assert float(row_median(x)[0]) == 2.5


# --------------------------------------------------------------------------
# banded smooth
# --------------------------------------------------------------------------

@pytest.mark.parametrize("window", [11, 101])
@pytest.mark.parametrize("lens", [[300, 150, 80, 41, 1, 2], [200, 1, 90]])
def test_smooth_plain_matches_reference(lens, window):
    jgo, tgo = gene_orders(lens)
    jop = jlayout.smoothing_operator(jgo, window)
    top = tlayout.smoothing_operator(tgo, window)
    x = np.random.default_rng(window).normal(size=(37, jgo.num_genes)).astype(np.float32)
    w = tsmooth.BandWeights.from_operator(top, "cpu")
    before = tsmooth.LAUNCHES
    got = tsmooth.apply_banded(torch.from_numpy(x), w).numpy()
    assert tsmooth.LAUNCHES == before     # CPU tensors take the plain version
    want_pallas = np.asarray(_apply_banded_pallas_k256(
        x, jnp.asarray(jop.shifted_blocks()), jop.n_tiles, jop.side_tiles,
        jop.num_genes, True))
    want_xla = np.asarray(_apply_banded(
        jnp.asarray(x), jnp.asarray(jop.blocks), jop.n_tiles, jop.side_tiles,
        jop.num_genes))
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=1e-6)
    # single-gene chromosomes pass through unsmoothed
    for (b, e) in tgo.chr_ranges():
        if e - b == 1:
            np.testing.assert_array_equal(got[:, b], x[:, b])


@pytest.mark.parametrize("lens,window", [([300, 150, 80, 41, 1, 2], 101),
                                         ([200, 1, 90], 11), ([37, 5], 21)])
def test_kernel_band_layout(lens, window):
    """The CUDA kernels' operands (kernel_band, common_column), applied as
    the kernels apply them to a zero-padded row, reproduce the smooth: the
    layout the card reads is checked here, where the kernel cannot run.  The
    common column is the band's most frequent one, and every gene that has
    it is smoothed the same from the column alone."""
    _, tgo = gene_orders(lens)
    w = tsmooth.BandWeights.from_operator(tlayout.smoothing_operator(tgo, window), "cpu")
    G, t4 = tgo.num_genes, w.halfband4
    band4, common = w.band4.numpy(), w.common.numpy()
    assert t4 % 4 == 0 and band4.shape == (2 * t4 + 4, -(-G // 4) * 4)
    _, counts = np.unique(band4.T, axis=0, return_counts=True)
    is_common = (band4 == common[:, None]).all(axis=0)
    assert is_common.sum() == counts.max()
    x = np.random.default_rng(2).normal(size=(5, G)).astype(np.float32)
    row = np.zeros((5, band4.shape[1] + 2 * t4 + 4), np.float32)
    row[:, t4:t4 + G] = x
    y = np.zeros((5, band4.shape[1]), np.float32)
    y_common = np.zeros_like(y)
    for e in range(band4.shape[0]):
        y += band4[e] * row[:, e:e + band4.shape[1]]
        y_common += common[e] * row[:, e:e + band4.shape[1]]
    want = tsmooth.apply_banded_plain(torch.from_numpy(x), w).numpy()
    np.testing.assert_allclose(y[:, :G], want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(y_common[:, is_common], y[:, is_common])


def test_dense_operator_matches_band():
    _, tgo = gene_orders([60, 1, 40])
    w = tsmooth.BandWeights.from_operator(tlayout.smoothing_operator(tgo, 11), "cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(5, 101)).astype(np.float32))
    np.testing.assert_allclose((x @ w.dense()).numpy(),
                               tsmooth.apply_banded_plain(x, w).numpy(), atol=1e-6)


# --------------------------------------------------------------------------
# fused residual
# --------------------------------------------------------------------------

RESID_CASES = [
    # (bounds, center, groups, counts dtype, lens)
    (True, "median", 2, "uint16", [200, 90, 51]),
    (True, "median", 1, "float32", [150, 150]),
    (True, "mean", 2, "float32", [200, 90, 51]),
    (False, "median", 2, "uint16", [150, 150]),
    (False, "mean", 1, "uint16", [200, 90, 51]),
    (True, "median", 3, "int32", [130, 1, 120]),
]


@pytest.mark.parametrize("use_bounds,center,groups,cdtype,lens", RESID_CASES)
def test_residual_plain_matches_pallas(use_bounds, center, groups, cdtype, lens):
    jgo, tgo = gene_orders(lens)
    G = jgo.num_genes
    rng = np.random.default_rng(groups * 10 + len(lens))
    gm = rng.gamma(2.0, 30.0, G)
    counts = rng.poisson(gm[None, :], (40, G)).astype(cdtype)
    nf = float(np.median(counts.sum(axis=1, dtype=np.float64)))
    ml = rng.normal(0, 0.1, (groups, G)).astype(np.float32)
    mr = rng.normal(0, 0.05, (groups, G)).astype(np.float32)
    if use_bounds:
        b = [ml.min(0), ml.max(0), mr.min(0), mr.max(0)]
    else:
        b = [ml.mean(0), ml.mean(0), mr.mean(0), mr.mean(0)]
    jop = jlayout.smoothing_operator(jgo, 101)
    want = np.asarray(residual_fused_pallas(
        counts, jop.stacked_blocks(), *b, nf, jop.n_tiles, G,
        center_mean=(center == "mean"), interpret=True))
    w = tsmooth.BandWeights.from_operator(tlayout.smoothing_operator(tgo, 101), "cpu")
    tb = [torch.from_numpy(np.ascontiguousarray(v)) for v in b]
    out = {}
    for odt in (torch.float32, torch.float16, torch.bfloat16):
        out[odt] = tres.residual_fused(torch.from_numpy(counts), w, *tb, nf,
                                       center_mean=(center == "mean"),
                                       out_dtype=odt)
        assert out[odt].dtype == odt
    np.testing.assert_allclose(out[torch.float32].numpy(), want, rtol=2e-5, atol=2e-5)
    for odt in (torch.float16, torch.bfloat16):
        assert torch.equal(out[odt], out[torch.float32].to(odt))


def test_residual_with_denoised_output():
    """Given the denoise bounds, the pass returns the residual and its
    denoised copy (the engine's subcluster and cells steps read both)."""
    _, tgo = gene_orders([150, 100, 57])
    G = tgo.num_genes
    rng = np.random.default_rng(6)
    counts = torch.from_numpy(rng.poisson(rng.gamma(2.0, 30.0, G)[None, :],
                                          (24, G)).astype(np.uint16))
    w = tsmooth.BandWeights.from_operator(tlayout.smoothing_operator(tgo, 101), "cpu")
    b = [torch.from_numpy(rng.normal(0, 0.05, G).astype(np.float32)) for _ in range(4)]
    b = [torch.minimum(b[0], b[1]), torch.maximum(b[0], b[1]),
         torch.minimum(b[2], b[3]), torch.maximum(b[2], b[3])]
    noise = torch.tensor([1.0, 0.02])
    resid, dn = tres.residual_fused(counts, w, *b, 1500.0, noise_bounds=noise)
    assert torch.equal(resid, tres.residual_fused(counts, w, *b, 1500.0))
    inside = (resid > 1.0 - 0.02) & (resid < 1.0 + 0.02)
    assert 0 < int(inside.sum()) < inside.numel()
    assert torch.equal(dn, torch.where(inside, torch.tensor(1.0), resid))


def test_residual_u16_counts_exact():
    """u16 -> f32 conversion is exact: u16 counts give the f32 result bit
    for bit (tests/test_kernels_pallas.py:244-261)."""
    _, tgo = gene_orders([150, 100, 57])
    G = tgo.num_genes
    rng = np.random.default_rng(5)
    counts = rng.poisson(rng.gamma(2.0, 30.0, G)[None, :], (24, G)).astype(np.uint16)
    counts[0, 0] = 65535
    w = tsmooth.BandWeights.from_operator(tlayout.smoothing_operator(tgo, 101), "cpu")
    b = [torch.zeros(G) for _ in range(4)]
    r16 = tres.residual_fused(torch.from_numpy(counts), w, *b, 1000.0)
    r32 = tres.residual_fused(torch.from_numpy(counts.astype(np.float32)), w, *b, 1000.0)
    assert torch.equal(r16, r32)
    np.testing.assert_array_equal(
        tres.counts_to_f32(torch.from_numpy(counts)).numpy(), counts.astype(np.float32))
    big = np.array([[0, 1, 4_000_000_000]], np.uint32)
    np.testing.assert_array_equal(
        tres.counts_to_f32(torch.from_numpy(big)).numpy(), big.astype(np.float32))


# --------------------------------------------------------------------------
# Viterbi
# --------------------------------------------------------------------------

def test_log_sf_matches_reference():
    from scipy.stats import norm

    z = np.linspace(0, 40, 2001).astype(np.float32)
    got = tvit.log_sf_std_normal(torch.from_numpy(z)).numpy()
    want = np.asarray(_log_sf_std_normal(jnp.asarray(z)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, norm.logsf(z.astype(np.float64)), rtol=2e-6)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("segmented", [False, True])
def test_viterbi_plain_matches_pallas(segmented):
    rng = np.random.default_rng(3 + segmented)
    B, L = 256, 200
    x = rng.normal(1.0, 0.25, (B, L)).astype(np.float32)
    x[10:40, 30:90] += 0.7
    x[50:90, 120:180] -= 0.5
    x[:8, 85:95] += 0.9                  # straddles the segment join at 90
    lengths = np.full(B, L, np.int32)
    lengths[100:140] = rng.integers(1, L, 40)
    bnd = np.zeros((B, L), np.int8)
    if segmented:
        bnd[:, [0, 90, 150]] = 1
        bnd[np.arange(L)[None, :] >= lengths[:, None]] = 0   # as packing makes them
    sigma = rng.uniform(0.15, 0.35, B).astype(np.float32)
    want = np.asarray(viterbi_pallas(x, lengths, sigma, MEANS, t=1e-6,
                                     boundaries=bnd, interpret=True))
    log_diag, log_off, log_delta = tvit.transition_logs(6, 1e-6)
    before = tvit.LAUNCHES
    got = tvit.viterbi(torch.from_numpy(x), torch.from_numpy(lengths),
                       torch.from_numpy(sigma), torch.from_numpy(bnd),
                       MEANS, log_delta, log_diag, log_off)
    assert tvit.LAUNCHES == before
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_viterbi_ignores_restarts_past_length():
    """A restart flag at or past a sequence's length is ignored, as the
    reference's XLA path masks it (infercnv_tpu/ops/viterbi_pack.py:214).
    The reference's Pallas kernel does not mask it: its backtrace jumps to
    state 1 in the padding and carries that into the valid positions
    (ROADMAP.md queue C).  The chromosome packing never sets such flags."""
    rng = np.random.default_rng(9)
    B, L = 32, 120
    x = rng.normal(1.0, 0.25, (B, L)).astype(np.float32)
    lengths = np.full(B, 60, np.int32)
    sigma = np.full(B, 0.25, np.float32)
    clean = np.zeros((B, L), np.int8)
    clean[:, [0, 30]] = 1
    past = clean.copy()
    past[:, 90] = 1
    log_diag, log_off, log_delta = tvit.transition_logs(6, 1e-6)

    def port(bnd):
        return tvit.viterbi(torch.from_numpy(x), torch.from_numpy(lengths),
                            torch.from_numpy(sigma), torch.from_numpy(bnd),
                            MEANS, log_delta, log_diag, log_off).numpy()

    def ref(bnd):
        return np.asarray(viterbi_pallas(x, lengths, sigma, MEANS, t=1e-6,
                                         boundaries=bnd, interpret=True))

    np.testing.assert_array_equal(port(past), port(clean))
    np.testing.assert_array_equal(port(clean), ref(clean))
    assert not np.array_equal(ref(past)[:, :60], ref(clean)[:, :60])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_viterbi_packed_matches_reference(use_pallas):
    """Bin-packed genome with a CNV straddling a chromosome join inside a bin
    (tests/test_parallel.py:199-227), against the reference's XLA scan and
    its interpreted Pallas kernel."""
    jgo, tgo = gene_orders([100, 40, 30, 20, 1])
    G = jgo.num_genes
    rng = np.random.default_rng(11)
    resid = rng.normal(1.0, 0.2, (16, G)).astype(np.float32)
    resid[8:, 95:140] += 0.8
    resid[4:8, 140:170] -= 0.5
    sigma = np.full(16, np.float32(np.median(SDS_ROUND)), np.float32)
    jh = JaxHMMParams(means=MEANS_ROUND, sds=SDS_ROUND, t=1e-6)
    jl = JaxPackedLayout.from_gene_order(jgo)
    want = np.asarray(jax_viterbi_packed(
        jnp.asarray(resid), jl, jnp.asarray(MEANS_ROUND, jnp.float32),
        jnp.asarray(sigma), jnp.asarray(jh.log_pi(), jnp.float32),
        jnp.asarray(np.log(jh.delta()), jnp.float32), MEANS_ROUND, 1e-6,
        use_pallas=use_pallas, interpret=use_pallas))
    got = viterbi_packed(torch.from_numpy(resid), get_layout(tgo), MEANS_ROUND,
                         torch.from_numpy(sigma), 1e-6)
    np.testing.assert_array_equal(np_(got), want)
    assert (np_(got)[:, G - 1] == 3).all()   # the 1-gene chromosome is neutral
