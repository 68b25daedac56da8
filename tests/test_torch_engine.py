"""The port's streaming engine as a whole (device="cpu": every kernel wrapper
runs its plain PyTorch version) against the JAX engine on the same numpy
inputs.

Tolerances: residuals rtol = atol = 2e-5 (tests/test_kernels_pallas.py:187-292);
Viterbi states exact; ref_stats rtol 1e-5 (atol 1e-6 for entries near zero),
the streamed form likewise (its accumulation order differs,
infercnv_tpu/parallel/engine.py:397-400); group sums rtol 1e-4, atol 1e-2
(tests/test_parallel.py:127); subcluster counts exact; f16/bf16 residuals
exactly the cast of the port's own f32 residual.  Chunk functions are fed the
JAX engine's reference statistics (interop.ref_stats_from_numpy), so each
chunk is compared on the same inputs whether or not ref_stats agrees."""

import dataclasses

import numpy as np
import pytest
import torch

from infercnv_tpu.models.hmm import I6_LEVELS
from infercnv_tpu.parallel.engine import CnvEngine as JaxEngine
from infercnv_tpu.parallel.engine import EngineConfig as JaxConfig
from infercnv_tpu_torch.interop import engine_from_numpy, ref_stats_from_numpy
from infercnv_tpu_torch.parallel import engine as port_engine
from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig

from torch_port_util import (MEANS, MEANS_ROUND, SDS, SDS_ROUND, gene_orders,
                             genome_fields, hmms, np_, realistic_sizes)

TREND = {lvl: (np.log(0.3) + 0.01 * i, -0.45) for i, lvl in enumerate(I6_LEVELS)}


def _engines(lens, means=MEANS_ROUND, sds=SDS_ROUND, use_pallas=False, **cfg):
    jgo, tgo = gene_orders(lens)
    jh, th = hmms(means, sds)
    return (JaxEngine(jgo, jh, JaxConfig(**cfg), use_pallas=use_pallas),
            CnvEngine(tgo, th, EngineConfig(**cfg), device="cpu"))


@pytest.fixture(scope="module")
def small():
    """tests/test_parallel.py:16-36: 3 x 96 genes, 64 cells, a planted 0.5x
    deletion on chr2 of cells 32+."""
    rng = np.random.default_rng(3)
    lens = [96, 96, 96]
    G = sum(lens)
    counts = rng.poisson(
        rng.gamma(2.0, 30.0, G)[None, :] * np.ones((64, 1))).astype(np.float32)
    counts[32:, 96:192] = np.maximum(counts[32:, 96:192] * 0.5, 0)
    nf = float(np.median(counts.sum(axis=1)))
    onehot_ref = np.zeros((2, 16), np.float32)
    onehot_ref[0, :8] = 1
    onehot_ref[1, 8:] = 1
    return lens, counts, nf, onehot_ref


def _close_denoised(got, want, pre, noise, rtol=2e-5, atol=2e-5):
    """Denoised residuals agree except where the pre-denoise value sits
    within the residual tolerance of a denoise threshold (there the two
    sides may fall on either side of it)."""
    mean_ref, spread = float(noise[0]), float(noise[1])
    near = np.minimum(np.abs(pre - (mean_ref - spread)),
                      np.abs(pre - (mean_ref + spread))) <= atol + rtol * np.abs(pre)
    ok = np.isclose(got, want, rtol=rtol, atol=atol) | near
    assert ok.all(), f"{(~ok).sum()} denoised values differ"


def test_engine_config_matches_reference():
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    assert tf == jf


@pytest.mark.parametrize("groups", [1, 2])
def test_ref_stats_matches(small, groups):
    lens, counts, nf, onehot_ref = small
    je, te = _engines(lens, window_length=11)
    oh = None if groups == 1 else onehot_ref
    want = je.ref_stats(counts[:16], nf, oh)
    got = te.ref_stats(counts[:16], nf, oh)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(np_(g), np_(w), rtol=1e-5, atol=1e-6)


def test_transform_chunk_out_dtypes(small):
    lens, counts, nf, onehot_ref = small
    je, _ = _engines(lens, window_length=11)
    ml, mr, nb = je.ref_stats(counts[:16], nf, onehot_ref)
    tml, tmr, _ = ref_stats_from_numpy(np_(ml), np_(mr), np_(nb), device="cpu")
    out = {}
    for odt in ("float32", "float16", "bfloat16"):
        jx, tx = _engines(lens, window_length=11, out_dtype=odt)
        want = jx.transform_chunk(counts, nf, ml, mr)
        out[odt] = tx.transform_chunk(counts, nf, tml, tmr)
        assert out[odt].dtype == getattr(torch, odt)
        if odt == "float32":
            np.testing.assert_allclose(np_(out[odt]), np_(want), rtol=2e-5, atol=2e-5)
    for odt in ("float16", "bfloat16"):
        assert torch.equal(out[odt], out["float32"].to(getattr(torch, odt)))


@pytest.mark.parametrize("cfg", [
    dict(window_length=11),
    dict(window_length=11, ref_subtract_use_bounds=False, center_method="mean"),
    dict(window_length=31, smooth_method="runmeans", max_centered_threshold=1.5),
])
def test_full_chunk_matches(small, cfg):
    lens, counts, nf, onehot_ref = small
    je, te = _engines(lens, **cfg)
    ml, mr, nb = je.ref_stats(counts[:16], nf, onehot_ref)
    jr_pre = np_(je.transform_chunk(counts, nf, ml, mr))
    jr, js = je.full_chunk(counts, nf, ml, mr, nb)
    tr, ts = te.full_chunk(counts, nf, *ref_stats_from_numpy(
        np_(ml), np_(mr), np_(nb), device="cpu"))
    np.testing.assert_array_equal(np_(ts), np_(js))
    _close_denoised(np_(tr), np_(jr), jr_pre, np_(nb))
    assert ts.dtype == torch.int8
    # the planted deletion is called
    assert (np_(ts)[32:, 96:192] < 3).mean() > 0.5


def test_subcluster_chunks_and_group_viterbi(small):
    lens, counts, nf, onehot_ref = small
    je, te = _engines(lens, window_length=11)
    ml, mr, nb = je.ref_stats(counts[:16], nf, onehot_ref)
    tstats = ref_stats_from_numpy(np_(ml), np_(mr), np_(nb), device="cpu")
    labels = (np.arange(64) >= 32).astype(int) * 2 + (np.arange(64) % 2)
    onehot = np.zeros((4, 64), np.float32)
    onehot[labels, np.arange(64)] = 1
    jacc = tacc = None
    for half in (slice(0, 32), slice(32, 64)):
        oh = np.ascontiguousarray(onehot[:, half])
        jr, *jacc = je.subcluster_chunk(counts[half], nf, ml, mr, nb, oh, acc=jacc)
        tr, *tacc = te.subcluster_chunk(counts[half], nf, *tstats, oh, acc=tacc)
        pre = np_(je.transform_chunk(counts[half], nf, ml, mr))
        _close_denoised(np_(tr), np_(jr), pre, np_(nb))
    np.testing.assert_allclose(np_(tacc[0]), np_(jacc[0]), rtol=1e-4, atol=1e-2)
    np.testing.assert_array_equal(np_(tacc[1]), np_(jacc[1]))
    gm = np_(jacc[0]) / np_(jacc[1])[:, None]
    js = je.viterbi_group_means(gm)
    ts = te.viterbi_group_means(gm)
    np.testing.assert_array_equal(np_(ts), np_(js))
    jt = je.viterbi_group_means(gm, np_(jacc[1]), TREND)
    tt = te.viterbi_group_means(gm, np_(jacc[1]), TREND)
    np.testing.assert_array_equal(np_(tt), np_(jt))
    assert (np_(ts)[2:, 96:192] < 3).mean() > 0.9     # tumour subclusters


def test_against_interpreted_pallas_engine(small):
    """The JAX engine with its Pallas kernels interpreted on the CPU."""
    lens, counts, nf, onehot_ref = small
    je, te = _engines(lens, use_pallas=True, window_length=11)
    assert je._pallas_interpret
    ml, mr, nb = je.ref_stats(counts[:16], nf, onehot_ref)
    tml, tmr, tnb = te.ref_stats(counts[:16], nf, onehot_ref)
    np.testing.assert_allclose(np_(tml), np_(ml), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(tmr), np_(mr), rtol=1e-5, atol=1e-6)
    tstats = ref_stats_from_numpy(np_(ml), np_(mr), np_(nb), device="cpu")
    np.testing.assert_allclose(np_(te.transform_chunk(counts, nf, *tstats[:2])),
                               np_(je.transform_chunk(counts, nf, ml, mr)),
                               rtol=2e-5, atol=2e-5)
    _, js = je.full_chunk(counts, nf, ml, mr, nb)
    _, ts = te.full_chunk(counts, nf, *tstats)
    np.testing.assert_array_equal(np_(ts), np_(js))


def test_ref_stats_streamed_matches(monkeypatch):
    """tests/test_parallel.py:230-267: the three-pass streamed statistics,
    called directly and through ref_stats above the streaming threshold,
    with the group membership as a numpy array and as a tensor."""
    lens = [200, 200, 200]
    rng = np.random.default_rng(3)
    G = sum(lens)
    counts = rng.poisson(rng.gamma(2.0, 20.0, G)[None, :], (700, G)).astype(np.float32)
    onehot = np.zeros((2, 700), np.float32)
    onehot[0, :350] = 1
    onehot[1, 350:] = 1
    nf = float(np.median(counts.sum(axis=1)))
    je, te = _engines(lens, means=np.arange(1.0, 7.0) / 3.0, sds=np.full(6, 0.1),
                      window_length=31, denoise=False)
    want = je._ref_stats_streamed(counts, nf, onehot, chunk=256)
    # the port takes the membership as a tensor too, as ref_stats passes it on
    got = te._ref_stats_streamed(counts.astype(np.uint16), nf,
                                 torch.from_numpy(onehot), chunk=256)
    oneshot = te.ref_stats(counts, nf, onehot)
    monkeypatch.setattr(port_engine, "_STREAM_REF_ELEMENTS", counts.size - 1)
    via_ref_stats = te.ref_stats(torch.from_numpy(counts), nf,
                                 torch.from_numpy(onehot))
    for g, w, o, v in zip(got, want, oneshot, via_ref_stats):
        np.testing.assert_allclose(np_(g), np_(w), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np_(g), np_(o), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np_(v), np_(w), rtol=1e-5, atol=1e-6)


def test_realistic_genome_states_and_calls():
    """22 chromosomes / 8448 genes (tests/test_parallel.py:72-133), 2 ref
    groups, planted 0.5x deletion on chr2 and 2x gain on chr5 in the tumour
    half: per-cell and group-mean states equal the reference's and call the
    planted CNVs."""
    rng = np.random.default_rng(5)
    sizes = list(realistic_sizes())
    jgo, tgo = gene_orders(sizes)
    C = 48
    lam = rng.gamma(2.0, 30.0, jgo.num_genes)[None, :] * np.ones((C, 1))
    chr2, chr5 = tgo.chr_gene_indices("chr2"), tgo.chr_gene_indices("chr5")
    lam[C // 2:, chr2] *= 0.5
    lam[C // 2:, chr5] *= 2.0
    counts = rng.poisson(lam).astype(np.uint16)
    nf = float(np.median(counts.sum(axis=1, dtype=np.float64)))
    onehot_ref = np.zeros((2, C // 2), np.float32)
    onehot_ref[0, :C // 4] = 1
    onehot_ref[1, C // 4:] = 1
    je, te = _engines(sizes, means=MEANS, sds=SDS)
    ml, mr, nb = je.ref_stats(counts[:C // 2].astype(np.float32), nf, onehot_ref)
    tstats = ref_stats_from_numpy(np_(ml), np_(mr), np_(nb), device="cpu")
    tml, tmr, tnb = te.ref_stats(counts[:C // 2], nf, onehot_ref)
    np.testing.assert_allclose(np_(tml), np_(ml), rtol=1e-5, atol=1e-6)
    _, js = je.full_chunk(counts, nf, ml, mr, nb)
    _, ts = te.full_chunk(counts, nf, *tstats)
    ts = np_(ts)
    np.testing.assert_array_equal(ts, np_(js))
    assert (ts[C // 2:][:, chr2] < 3).mean() > 0.7
    assert (ts[C // 2:][:, chr5] > 3).mean() > 0.7
    assert (ts[:C // 2] == 3).mean() > 0.9
    onehot = np.zeros((2, C), np.float32)
    onehot[0, :C // 2] = 1
    onehot[1, C // 2:] = 1
    _, gs, gc = te.subcluster_chunk(counts, nf, *tstats, onehot)
    _, jgs, jgc = je.subcluster_chunk(counts, nf, ml, mr, nb, onehot)
    np.testing.assert_allclose(np_(gs), np_(jgs), rtol=1e-4, atol=1e-2)
    gm = np_(jgs) / np_(jgc)[:, None]
    gstates = np_(te.viterbi_group_means(gm))
    np.testing.assert_array_equal(gstates, np_(je.viterbi_group_means(gm)))
    assert (gstates[1, chr2] < 3).mean() > 0.7 and (gstates[1, chr5] > 3).mean() > 0.7
    assert (gstates[0] == 3).mean() > 0.9


def test_interop_engine_from_numpy(small):
    lens, counts, nf, onehot_ref = small
    f = genome_fields(lens)
    e = engine_from_numpy(f, dict(means=MEANS_ROUND, sds=SDS_ROUND, t=1e-6),
                          dict(window_length=11), device="cpu")
    _, te = _engines(lens, window_length=11)
    assert e.config == te.config and e.device.type == "cpu"
    assert e.gene_order.fingerprint() == te.gene_order.fingerprint()
    for a, b in zip(e.ref_stats(counts[:16], nf), te.ref_stats(counts[:16], nf)):
        assert torch.equal(a, b)
    stats = ref_stats_from_numpy(np.zeros((2, 3)), np.zeros((2, 3)), np.zeros(2),
                                 device="cpu")
    assert all(s.dtype == torch.float32 and s.device.type == "cpu" for s in stats)


def test_median_radix_bits_not_dividing_32():
    """A digit width that does not divide 32 (ROADMAP C1): the reference
    accepts it and its median is exact for any width, so the port runs it
    too and matches, 300 genes, within rtol = atol = 2e-5."""
    rng = np.random.default_rng(11)
    lens = [100, 100, 100]
    counts = rng.poisson(rng.gamma(2.0, 30.0, 300)[None, :]
                         * np.ones((40, 1))).astype(np.float32)
    counts[20:, 100:200] = np.round(counts[20:, 100:200] * 0.5)
    nf = float(np.median(counts.sum(axis=1)))
    je, te = _engines(lens, window_length=21, median_radix_bits=3)
    ml, mr, nb = je.ref_stats(counts[:12], nf)
    got = te.ref_stats(counts[:12], nf)
    for g, w in zip(got, (ml, mr, nb)):
        np.testing.assert_allclose(np_(g), np_(w), rtol=2e-5, atol=2e-5)
    tml, tmr, _ = ref_stats_from_numpy(np_(ml), np_(mr), np_(nb), device="cpu")
    np.testing.assert_allclose(np_(te.transform_chunk(counts, nf, tml, tmr)),
                               np_(je.transform_chunk(counts, nf, ml, mr)),
                               rtol=2e-5, atol=2e-5)
