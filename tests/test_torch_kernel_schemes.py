"""The schemes of the port's redesigned CUDA kernels, replayed in numpy on the
CPU (the kernels themselves run only on the card): the fused residual
kernel's row plan and its smooth (csrc/residual_fused.cu), the general
smooth's per-warp tap ranges (csrc/smooth_general.cu), and the radix select
with its folded lower middle (csrc/radix_select.cuh).  Each replay is held
to the port's plain version and to the JAX package on the same numpy inputs.

Tolerances: smooths rtol = atol = 2e-5 against the reference (its residual
tolerance) and atol 1e-6 against the plain version (both f32 products summed
in another order); medians bit-exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from infercnv_tpu.ops import layout as jlayout
from infercnv_tpu.ops.median import row_median_pallas
from infercnv_tpu.ops.smoothing import _apply_banded
from infercnv_tpu_torch.ops import layout as tlayout
from infercnv_tpu_torch.ops import smoothing as tsmooth
from infercnv_tpu_torch.ops.median import row_median_plain

from torch_port_util import gene_orders, median_cases

#: genomes of the plan cases: the bench genome's shape (22 chromosomes of
#: 800 down to 120 genes, scaled to 2000), chromosomes of 1 and 2 genes, and
#: 40 chromosomes of 3 genes (too many gaps: the plan keeps none)
BENCH_LENS = (np.linspace(800, 120, 22) / np.linspace(800, 120, 22).sum()
              * 2000).astype(int).tolist()
PLAN_CASES = {
    "bench_f32": (BENCH_LENS, 101, False),
    "bench_bf16": (BENCH_LENS, 101, True),
    "tiny_chromosomes_f32": ([300, 150, 80, 41, 1, 2], 101, False),
    "tiny_chromosomes_bf16": ([300, 150, 80, 41, 1, 2], 101, True),
    "window_51": ([150, 150, 33], 51, False),
    "no_gaps": ([3] * 40, 101, False),
    "coordinates": ("coordinates", 80_000, False),
}


def _operator(lens, window):
    if lens == "coordinates":
        jgo, tgo = gene_orders([300, 200, 150])
        return (jlayout.coordinate_smoothing_operator(jgo, window),
                tlayout.coordinate_smoothing_operator(tgo, window))
    jgo, tgo = gene_orders(lens)
    return (jlayout.smoothing_operator(jgo, window),
            tlayout.smoothing_operator(tgo, window))


def replay_fused_smooth(w: tsmooth.BandWeights, x: np.ndarray) -> np.ndarray:
    """The smooth of csrc/residual_fused.cu as its plan drives it: the row
    laid out with gap zeros between segments, 8-coordinate items on the
    common column (scaled sums for the scaled bit), bf16 scaled items with
    weights bf16(scale * common32), and general genes from band4.  Asserts
    that every gene is computed exactly once."""
    p = w.plan
    G, t4 = w.num_genes, w.halfband4
    band4, common = w.band4.numpy(), w.common.numpy().astype(np.float64)
    if w.bf16:
        x = tsmooth.round_bf16(x)
    genes = np.arange(G)
    coord = genes + p.gap * (np.searchsorted(p.seg, genes, side="right") - 1)
    P = ((p.span + 7) // 8 * 8 + 2 * t4 + 16 + 63) // 64 * 64
    row = np.zeros((x.shape[0], P))
    row[:, coord + t4] = x
    gene_at = np.full(P, -1)
    gene_at[coord] = genes
    y = np.full((x.shape[0], G), np.nan)
    taps = np.arange(p.c_lo, p.c_hi)
    for items, scales, bf16 in ((p.items, p.iscale, False),
                                (p.sitems, p.sscale, True)):
        for it, sc in zip(items, scales):
            q, scaled, mask = it >> 9, (it >> 8) & 1, it & 0xFF
            assert scaled or not bf16
            for j in range(8):
                if mask >> j & 1:
                    o = 8 * q + j
                    g = gene_at[o]
                    assert g >= 0 and np.isnan(y[0, g])
                    if bf16:
                        wt = tsmooth.round_bf16(np.float32(sc[j]) * p.common32[taps])
                        y[:, g] = row[:, o + taps] @ wt.astype(np.float64)
                    else:
                        y[:, g] = row[:, o + taps] @ common[taps]
                        if scaled:
                            y[:, g] *= sc[j]
    for (g, o), tp in zip(p.general, p.gtaps):
        assert np.isnan(y[0, g])
        e = np.arange(tp & 0xFFFF, tp >> 16)
        y[:, g] = row[:, o + e] @ band4[e, g].astype(np.float64)
    assert not np.isnan(y).any()
    return y


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_fused_plan_replays_the_smooth(name):
    lens, window, bf16 = PLAN_CASES[name]
    jop, top = _operator(lens, window)
    w = tsmooth.BandWeights.from_operator(top, "cpu", bf16=bf16)
    p, t4 = w.plan, w.halfband4
    # gaps of t4 >= halfband zeros between segments, or none at all
    assert p.gap in (0, t4) and p.span == w.num_genes + p.gap * (p.seg.shape[0] - 2)
    assert (np.diff(p.seg) >= 8).all() or p.seg.shape[0] == 2
    if name == "no_gaps":
        assert p.gap == 0 and p.seg.tolist() == [0, w.num_genes]
    elif name == "coordinates":       # no common column: nearly all general
        assert p.general.shape[0] > 0.9 * w.num_genes
    elif name.startswith("tiny"):     # chromosomes of 1 and 2 genes join the
        assert p.gap == t4 and p.seg.shape[0] == 5      # 41-gene one
        assert 0 < p.general.shape[0] < 0.2 * w.num_genes
    else:                             # renormalised ends: all scaled common
        assert p.gap == t4 and p.general.shape[0] == 0
    x = np.random.default_rng(3).normal(size=(6, w.num_genes)).astype(np.float32)
    got = replay_fused_smooth(w, x)
    plain = tsmooth.apply_banded_plain(torch.from_numpy(x), w).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-6)
    if not bf16:
        want = np.asarray(_apply_banded(jnp.asarray(x), jnp.asarray(jop.blocks),
                                        jop.n_tiles, jop.side_tiles, jop.num_genes))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["bench_f32", "bench_bf16", "window_51"])
def test_common_column_trim(name):
    """The fused kernel sums the common column over [c_lo, c_hi) only: the
    taps outside hold no weight, so its trimmed window sums equal the
    full-column sums."""
    lens, window, bf16 = PLAN_CASES[name]
    _, top = _operator(lens, window)
    w = tsmooth.BandWeights.from_operator(top, "cpu", bf16=bf16)
    p, common = w.plan, w.common.numpy().astype(np.float64)
    E = common.shape[0]
    assert p.c_lo % 4 == 0 and p.c_hi % 4 == 0 and 0 <= p.c_lo < p.c_hi <= E
    assert not common[:p.c_lo].any() and not common[p.c_hi:].any()
    assert common[p.c_lo:p.c_hi].sum() == common.sum()
    assert p.c_hi - p.c_lo < E                  # 104 of 108 taps at window 101
    x = np.random.default_rng(4).normal(size=(3, E + 8))
    for o in range(8):
        full = sum(common[e] * x[:, o + e] for e in range(E))
        trimmed = sum(common[e] * x[:, o + e] for e in range(p.c_lo, p.c_hi))
        np.testing.assert_array_equal(trimmed, full)


@pytest.mark.parametrize("kind", ["coordinates", "pyramidal", "wide"])
def test_general_warp_taps(kind):
    """csrc/smooth_general.cu: each warp sums its own 32 genes' taps
    [lo, hi) (warp_taps), multiples of 4 inside its tile's staged range that
    hold every nonzero weight of its genes; summed so, the smooth is the
    plain version's."""
    if kind == "coordinates":
        jop, top = _operator("coordinates", 80_000)
    elif kind == "pyramidal":
        jop, top = _operator([300, 150, 80, 41, 1, 2], 101)
    else:
        jop, top = _operator([1500, 700, 33], 101)
    w = tsmooth.BandWeights.from_operator(top, "cpu")
    band4 = w.band4.numpy()
    E, Gr = band4.shape
    wt = w.warp_taps.numpy()
    wlo, whi = wt & 0xFFFF, wt >> 16
    lo, hi = w.tap_lo.numpy(), w.tap_hi.numpy()
    WG, TG = tsmooth.GENERAL_WARP, tsmooth.GENERAL_TILE
    assert wt.shape[0] == -(-Gr // WG)
    assert (wlo % 4 == 0).all() and (whi % 4 == 0).all() and (whi >= wlo).all()
    x = np.random.default_rng(6).normal(size=(4, w.num_genes)).astype(np.float32)
    t4 = w.halfband4
    xp = np.zeros((4, Gr + 2 * t4 + 4))
    xp[:, t4:t4 + w.num_genes] = x
    y = np.zeros((4, Gr))
    spans = []
    for k in range(wt.shape[0]):
        cols = np.arange(k * WG, min((k + 1) * WG, Gr))
        nz = np.nonzero(band4[:, cols].any(axis=1))[0]
        if nz.size:
            assert wlo[k] <= nz[0] and nz[-1] < whi[k]
            tile = k * WG // TG
            assert lo[tile] <= wlo[k] and whi[k] <= hi[tile]
        spans.append(whi[k] - wlo[k])
        for e in range(wlo[k], whi[k]):
            y[:, cols] += band4[e, cols] * xp[:, cols + e]
    assert np.mean(spans) <= np.mean(hi - lo)
    plain = tsmooth.apply_banded_plain(torch.from_numpy(x), w).numpy()
    np.testing.assert_allclose(y[:, :w.num_genes], plain, rtol=0, atol=1e-6)
    want = np.asarray(_apply_banded(jnp.asarray(x), jnp.asarray(jop.blocks),
                                    jop.n_tiles, jop.side_tiles, jop.num_genes))
    np.testing.assert_allclose(y[:, :w.num_genes], want, rtol=2e-5, atol=2e-5)


# ---- the radix select of csrc/radix_select.cuh -------------------------

SHIFTS, BITS = (21, 10, 0), (11, 11, 10)


def f2key(v: np.ndarray) -> np.ndarray:
    u = np.asarray(v, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def key2f(k: int) -> np.float32:
    k = np.uint32(k)
    u = k & np.uint32(0x7FFFFFFF) if k & np.uint32(0x80000000) else ~k
    return np.array([u], np.uint32).view(np.float32)[0]


def replay_select(values: np.ndarray, k: int):
    """radix_select_row: three passes of 11/11/10-bit digits; returns the
    k-th key, k minus the keys below it, the largest key below the last
    prefix's range, and the last histogram."""
    keys = f2key(values).astype(np.uint64)
    prefix, krem, below = 0, k, 0
    for p in range(3):
        shift, bits = SHIFTS[p], BITS[p]
        hmask = 0 if p == 0 else (0xFFFFFFFF << (shift + bits)) & 0xFFFFFFFF
        match = ((keys ^ prefix) & hmask) == 0
        if p == 2:
            low = keys[~match & (keys < prefix)]
            below = int(low.max()) if low.size else 0
        hist = np.bincount(((keys[match] >> shift) & ((1 << bits) - 1)).astype(np.int64),
                           minlength=1 << bits)
        cum = np.cumsum(hist)
        b = int(np.searchsorted(cum, krem, side="right"))
        krem -= int(cum[b] - hist[b])
        prefix |= b << shift
    return prefix, krem, below, hist


def replay_median(values: np.ndarray, G: int) -> np.float32:
    """block_row_median over values (G genes, then any +inf fill): the upper
    middle by the select; for even G the lower middle is folded into the
    last pass (the upper middle again if it repeats below its rank, else the
    last histogram's largest nonempty bin below it, else the largest key
    below the last prefix's range)."""
    v2, krem, below, hist = replay_select(values, G // 2)
    if G % 2:
        return key2f(v2)
    if krem > 0:
        v1 = v2
    else:
        nz = np.nonzero(hist[:v2 & 1023])[0]
        v1 = (v2 & ~1023) | int(nz[-1]) if nz.size else below
    return np.float32((key2f(v1) + key2f(v2)) * np.float32(0.5))


def _select_rows():
    rng = np.random.default_rng(11)
    rows = {}
    for G in (1, 2, 7, 8, 255, 256, 1001, 1000):
        rows[f"normal_{G}"] = rng.normal(0, 0.3, G).astype(np.float32)
    rows["heavy_ties"] = rng.integers(-2, 3, 1000).astype(np.float32) * 0.25
    rows["mostly_zero"] = np.where(rng.random(999) < 0.9, 0.0,
                                   rng.normal(size=999)).astype(np.float32)
    rows["all_equal_even"] = np.full(64, 0.375, np.float32)
    rows["all_equal_odd"] = np.full(65, -1.5, np.float32)
    rows["signed_zeros"] = np.array([-0.0, 0.0, -0.0, 0.0, 1.0, -1.0], np.float32)
    tiny = np.float32(np.finfo(np.float32).tiny)
    rows["subnormals"] = (rng.integers(-40, 41, 301).astype(np.float32)
                          * tiny * np.float32(2.0 ** -10))
    rows["subnormals_even"] = rows["subnormals"][:300].copy()
    rows["lower_middle_below_range"] = np.array([1.0, 1.0009766, 2.0, -3.0],
                                                np.float32)
    for name, x in median_cases().items():
        for i, r in enumerate(x):
            rows[f"{name}_{i}"] = r
    return rows


SELECT_ROWS = _select_rows()


@pytest.mark.parametrize("name", sorted(SELECT_ROWS))
def test_select_scheme_is_numpy_median(name):
    """The replay equals np.median bit for bit (a zero median in either
    sign: numpy's partition leaves -0 and +0 unordered, the keys put -0
    first, as the reference's do) and the port's plain median exactly; with
    the fused kernel's +inf gaps appended it selects the same value."""
    x = SELECT_ROWS[name]
    G = x.shape[0]
    got = replay_median(x, G)
    want = np.float32(np.median(x))
    if want == 0:
        assert got == 0
    else:
        assert np.float32(got).view(np.uint32) == want.view(np.uint32)
    plain = row_median_plain(torch.from_numpy(x[None, :])).numpy()[0]
    assert np.float32(got).view(np.uint32) == plain.view(np.uint32)
    gapped = np.concatenate([x, np.full(52 * 3, np.inf, np.float32)])
    assert np.float32(replay_median(gapped, G)).view(np.uint32) == \
        np.float32(got).view(np.uint32)


def test_select_scheme_matches_pallas():
    """The replay against the reference's interpreted Pallas median on the
    shared median cases (odd and even widths, ties, +-inf, -0)."""
    for name, x in median_cases().items():
        want = np.asarray(row_median_pallas(jnp.asarray(x), interpret=True))
        got = np.array([replay_median(r, x.shape[1]) for r in x], np.float32)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.astype(np.float32).view(np.uint32))
