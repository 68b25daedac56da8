"""The port's engine on each route of its residual (device="cpu": every kernel
wrapper runs its plain PyTorch version) against the JAX engine on the same
numpy inputs:

* coordinate smoothing with the i3 HMM (the "wide_band" route: the tiled
  smooth, then the row median), against CnvEngine(use_pallas=False) and the
  reference's interpreted Pallas engine;
* matmul_dtype="bfloat16" (the fused kernel and the one-row smooth with bf16
  operands), against the interpreted Pallas engine, which rounds the same
  operands, and against the f32 XLA engine;
* a genome too wide for the one-row kernels (the "wide_genome" route: the
  tiled smooth, then the median-centred tail), forced on a small genome by
  shrinking the shared memory the port plans with, against the XLA engine
  and against the interpreted Pallas engine forced onto its own unfused
  route (smooth kernel, then _median_epilogue_kernel).

Tolerances as tests/test_torch_engine.py: residuals rtol = atol = 2e-5,
ref_stats rtol 1e-5 (atol 1e-6), group sums rtol 1e-4 / atol 1e-2, states
equal.  The bf16 route against the f32 XLA engine: rtol = atol = 2e-2 (the
bf16 operands move a smooth by up to ~0.8% of sum|w||x|, and exp2 carries
that into the residual)."""

import numpy as np
import pytest

from infercnv_tpu.models import hmm as jhmm
from infercnv_tpu.parallel.engine import CnvEngine as JaxEngine
from infercnv_tpu.parallel.engine import EngineConfig as JaxConfig
from infercnv_tpu_torch.interop import engine_from_numpy, ref_stats_from_numpy
from infercnv_tpu_torch.models import hmm as thmm
from infercnv_tpu_torch.parallel import engine as port_engine
from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig

from torch_port_util import gene_orders, genome_fields, hmms, np_

#: 650 genes 1 kbp apart: an 80 kbp window gives halfband > 128 (2 side tiles)
COORD = dict(smooth_method="coordinates", window_length=80_000)
COORD_LENS = [300, 200, 150]


def _data(lens, seed, cells=48):
    """u16 counts with a 1.5x gain on chr1 and a 0.5x loss on chr2 in the
    second half of the cells; the first 16 cells are the reference, in two
    groups; two subclusters in each half."""
    rng = np.random.default_rng(seed)
    G = sum(lens)
    lam = rng.gamma(2.0, 30.0, G)[None, :] * np.ones((cells, 1))
    c1 = slice(0, lens[0])
    c2 = slice(lens[0], lens[0] + lens[1])
    lam[cells // 2:, c1] *= 1.5
    lam[cells // 2:, c2] *= 0.5
    counts = rng.poisson(lam).astype(np.uint16)
    nf = float(np.median(counts.sum(axis=1, dtype=np.float64)))
    onehot_ref = np.zeros((2, 16), np.float32)
    onehot_ref[0, :8] = 1
    onehot_ref[1, 8:] = 1
    labels = (np.arange(cells) >= cells // 2) * 2 + np.arange(cells) % 2
    onehot = np.zeros((4, cells), np.float32)
    onehot[labels, np.arange(cells)] = 1
    return counts, nf, onehot_ref, onehot, c1, c2


def _pair(lens, jh, th, use_pallas=False, **cfg):
    jgo, tgo = gene_orders(lens)
    return (JaxEngine(jgo, jh, JaxConfig(**cfg), use_pallas=use_pallas),
            CnvEngine(tgo, th, EngineConfig(**cfg), device="cpu"))


def _compare(je, te, counts, nf, onehot_ref, onehot, resid_tol=2e-5):
    """ref_stats, transform_chunk, full_chunk, subcluster_chunk and
    viterbi_group_means of the two engines; chunk steps take the JAX
    engine's statistics, so each is compared on the same inputs.  Returns
    the port's group-mean states."""
    ml, mr, nb = je.ref_stats(counts[:16].astype(np.float32), nf, onehot_ref)
    for g, w in zip(te.ref_stats(counts[:16], nf, onehot_ref), (ml, mr, nb)):
        np.testing.assert_allclose(np_(g), np_(w), rtol=max(1e-5, resid_tol),
                                   atol=max(1e-6, resid_tol))
    stats = ref_stats_from_numpy(np_(ml), np_(mr), np_(nb), device="cpu")
    np.testing.assert_allclose(np_(te.transform_chunk(counts, nf, *stats[:2])),
                               np_(je.transform_chunk(counts, nf, ml, mr)),
                               rtol=resid_tol, atol=resid_tol)
    _, js = je.full_chunk(counts, nf, ml, mr, nb)
    _, ts = te.full_chunk(counts, nf, *stats)
    if resid_tol == 2e-5:
        np.testing.assert_array_equal(np_(ts), np_(js))
    _, tsum, tcnt = te.subcluster_chunk(counts, nf, *stats, onehot)
    _, jsum, jcnt = je.subcluster_chunk(counts, nf, ml, mr, nb, onehot)
    np.testing.assert_allclose(np_(tsum), np_(jsum), rtol=max(1e-4, resid_tol),
                               atol=1e-2)
    np.testing.assert_array_equal(np_(tcnt), np_(jcnt))
    gm = np_(jsum) / np_(jcnt)[:, None]
    tstates = np_(te.viterbi_group_means(gm))
    np.testing.assert_array_equal(tstates, np_(je.viterbi_group_means(gm)))
    return tstates


@pytest.fixture(scope="module")
def coord_case():
    """Coordinate smoothing, then the i3 parameters from the transformed
    reference cells, as run() derives them (reference R/inferCNV_ops.R:353-361)."""
    counts, nf, onehot_ref, onehot, c1, c2 = _data(COORD_LENS, 40)
    jh6, th6 = hmms()
    je, te = _pair(COORD_LENS, jh6, th6, **COORD)
    ml, mr, _ = je.ref_stats(counts[:16].astype(np.float32), nf, onehot_ref)
    stats = ref_stats_from_numpy(np_(ml), np_(mr), np.zeros(2), device="cpu")
    jt = np_(je.transform_chunk(counts[:16], nf, ml, mr))
    tt = np_(te.transform_chunk(counts[:16], nf, *stats[:2]))
    refs = [np.arange(8), np.arange(8, 16)]
    jh3 = jhmm.i3_hmm_params(jt, refs, [])
    th3 = thmm.i3_hmm_params(tt, refs, [])
    return counts, nf, onehot_ref, onehot, c1, c2, jh3, th3


def test_coordinates_i3_route(coord_case):
    counts, nf, onehot_ref, onehot, c1, c2, jh3, th3 = coord_case
    np.testing.assert_allclose(th3.means, jh3.means, rtol=1e-5)
    np.testing.assert_allclose(th3.sds, jh3.sds, rtol=1e-4)
    th_same = thmm.HMMParams(means=jh3.means, sds=jh3.sds, t=jh3.t)
    je, te = _pair(COORD_LENS, jh3, th_same, denoise=True, sd_amplifier=1.5,
                   **COORD)
    assert te.weights.side_tiles == 2 and te.weights.halfband > 128
    assert (te.residual_route, te.smooth_route) == ("wide_band", "general")
    states = _compare(je, te, counts, nf, onehot_ref, onehot)
    # the planted gain and loss in the tumour subclusters (rows 2, 3), i3
    # states 3 / 1; the normal subclusters neutral (2)
    assert (states[2:, c1] == 3).mean() > 0.7
    assert (states[2:, c2] == 1).mean() > 0.7
    assert (states[:2] == 2).mean() > 0.9


def test_coordinates_i3_against_interpreted_pallas(coord_case):
    """The reference's Pallas engine (interpreted on the CPU) runs the
    general (2S+1)-side smooth kernel and the Pallas row median here."""
    counts, nf, onehot_ref, _, _, _, jh3, _ = coord_case
    th = thmm.HMMParams(means=jh3.means, sds=jh3.sds, t=jh3.t)
    je, te = _pair(COORD_LENS, jh3, th, use_pallas=True, **COORD)
    assert je._pallas_interpret and je._w_stacked is None
    few = counts[12:28]
    ml, mr, nb = je.ref_stats(counts[:16].astype(np.float32), nf, onehot_ref)
    tml, tmr, _ = te.ref_stats(counts[:16], nf, onehot_ref)
    np.testing.assert_allclose(np_(tml), np_(ml), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(tmr), np_(mr), rtol=1e-5, atol=1e-6)
    stats = ref_stats_from_numpy(np_(ml), np_(mr), np_(nb), device="cpu")
    np.testing.assert_allclose(np_(te.transform_chunk(few, nf, *stats[:2])),
                               np_(je.transform_chunk(few, nf, ml, mr)),
                               rtol=2e-5, atol=2e-5)
    _, js = je.full_chunk(few, nf, ml, mr, nb)
    _, ts = te.full_chunk(few, nf, *stats)
    np.testing.assert_array_equal(np_(ts), np_(js))


def test_bf16_route_against_interpreted_pallas():
    """The bf16 operands of the reference's fused kernel and K=256 smooth
    (halfband 50 <= 64), interpreted, against the port's plain versions."""
    lens = [200, 90, 51]
    counts, nf, onehot_ref, onehot, _, _ = _data(lens, 41)
    jh, th = hmms()
    je, te = _pair(lens, jh, th, use_pallas=True, matmul_dtype="bfloat16")
    assert je._w_stacked is not None and je._w_shifted is not None
    assert te.residual_route == "fused" and te.smooth_route == "row"
    assert te._w_fused.bf16 and te._w_smooth.bf16 and not te.weights.bf16
    few = counts[8:40]
    _compare(je, te, few, nf, onehot_ref, onehot[:, 8:40])


def test_bf16_route_near_f32():
    lens = [200, 90, 51]
    counts, nf, onehot_ref, onehot, _, _ = _data(lens, 41)
    jh, th = hmms()
    je, te = _pair(lens, jh, th, matmul_dtype="bfloat16")
    _compare(je, te, counts, nf, onehot_ref, onehot, resid_tol=2e-2)
    _, tf = _pair(lens, jh, th)
    a = np_(te.transform_chunk(counts, nf, *te.ref_stats(counts[:16], nf)[:2]))
    b = np_(tf.transform_chunk(counts, nf, *tf.ref_stats(counts[:16], nf)[:2]))
    assert not np.array_equal(a, b)          # the bf16 operands did engage


def test_bf16_halfband_over_64_rounds_only_the_fused_kernel():
    """As the reference: with 64 < halfband <= 128 the fused kernel takes the
    bf16 flag, its smooth of ref_stats (the general kernel) stays f32
    (infercnv_tpu/parallel/engine.py:112-114, :202-210)."""
    _, tgo = gene_orders([200, 150])
    _, th = hmms()
    te = CnvEngine(tgo, th, EngineConfig(window_length=201,
                                         matmul_dtype="bfloat16"), device="cpu")
    assert te.weights.halfband == 100
    assert (te.residual_route, te.smooth_route) == ("fused", "general")
    assert te._w_fused.bf16 and not te._w_smooth.bf16


@pytest.mark.parametrize("center", ["median", "mean"])
def test_wide_genome_route(monkeypatch, center):
    """Shared memory too small for any one-row kernel: the median-centred
    tail (or, for mean centring, the wide-band route) after the tiled
    smooth, against the XLA engine."""
    lens = [200, 90, 51]
    counts, nf, onehot_ref, onehot, _, _ = _data(lens, 42)
    jh, th = hmms()
    monkeypatch.setattr(port_engine, "SMEM_OPTIN_BYTES", 1_024)
    je, te = _pair(lens, jh, th, center_method=center)
    assert te.smooth_route == "general"
    assert te.residual_route == ("wide_genome" if center == "median" else "wide_band")
    _compare(je, te, counts, nf, onehot_ref, onehot)


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_wide_genome_against_interpreted_pallas(monkeypatch, matmul_dtype):
    """The reference's own unfused Pallas route, forced by a fused-kernel
    capacity of 0 rows: the K=256 smooth, then _median_epilogue_kernel (f32),
    or the bf16 K=256 smooth, then the Pallas row median and XLA's epilogue
    (bf16; the port's general smooth takes the bf16 operands there too)."""
    from infercnv_tpu.ops import residual_fused as jres

    lens = [200, 90, 51]
    counts, nf, onehot_ref, onehot, _, _ = _data(lens, 43)
    jh, th = hmms()
    monkeypatch.setattr(jres, "_pick_tile_r", lambda Gp, n_tiles: 0)
    monkeypatch.setattr(port_engine, "SMEM_OPTIN_BYTES", 1_024)
    je, te = _pair(lens, jh, th, use_pallas=True, matmul_dtype=matmul_dtype)
    assert je._w_stacked is None and je._w_shifted is not None
    assert te.residual_route == "wide_genome"
    assert te._w_smooth.bf16 == (matmul_dtype == "bfloat16")
    # the residual is what this route changes; its states are compared with
    # the XLA engine's in test_wide_genome_route
    ml, mr, _ = je.ref_stats(counts[:16].astype(np.float32), nf, onehot_ref)
    stats = ref_stats_from_numpy(np_(ml), np_(mr), np.zeros(2), device="cpu")
    few = counts[8:40]
    np.testing.assert_allclose(np_(te.transform_chunk(few, nf, *stats[:2])),
                               np_(je.transform_chunk(few, nf, ml, mr)),
                               rtol=2e-5, atol=2e-5)


def test_interop_carries_the_routes_options(coord_case):
    """engine_from_numpy with a JAX engine's smooth_method, window_length,
    matmul_dtype and a 3-state HMM."""
    *_, jh3, _ = coord_case
    jgo, _ = gene_orders(COORD_LENS)
    cfg = JaxConfig(smooth_method="coordinates", window_length=80_000,
                    matmul_dtype="bfloat16")
    je = JaxEngine(jgo, jh3, cfg, use_pallas=False)
    f = genome_fields(COORD_LENS)
    te = engine_from_numpy(
        f, dict(means=je.hmm.means, sds=je.hmm.sds, t=je.hmm.t),
        {k: getattr(je.config, k) for k in ("smooth_method", "window_length",
                                            "matmul_dtype")}, device="cpu")
    assert te.config == EngineConfig(smooth_method="coordinates",
                                     window_length=80_000, matmul_dtype="bfloat16")
    assert te.hmm.num_states == 3
    np.testing.assert_array_equal(te.hmm.means, jh3.means)
    assert te.weights.side_tiles == je._op_meta[1] == 2
    # halfband > 64 and 2 side tiles: no bf16 rounding anywhere, as the reference
    assert te.residual_route == "wide_band" and not te._w_smooth.bf16
    rng = np.random.default_rng(2)
    resid = rng.normal(1.0, 0.05, (3, te.gene_order.num_genes)).astype(np.float32)
    np.testing.assert_array_equal(np_(te.viterbi_group_means(resid)),
                                  np_(je.viterbi_group_means(resid)))
