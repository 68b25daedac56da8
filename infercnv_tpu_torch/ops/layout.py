"""Static genome layouts for segment-aware gene-axis kernels.

Copied from infercnv_tpu/ops/layout.py (all of it; plain numpy), so that the
port never imports the JAX package.  One addition: ``BandedGeneOperator``
keeps the dense ``[2t+1, G]`` band it was built from (``.band``), which is
the operand the CUDA kernels take directly; the 128-wide tile blocks stay
for the plain PyTorch version and for parity with the reference layout.

The reference smooths per chromosome with a moving average that never crosses
chromosome boundaries and renormalizes truncated windows at chromosome ends
(reference R/inferCNV_ops.R:2406-2434 ``smooth_by_chromosome``,
``.smooth_helper`` :2483-2532, ``.smooth_center_helper`` :2640-2661).

Mathematically, for kernel weights k (triangular for 'pyramidinal', flat for
'runmeans'), the smoothed value is

    y[g] = sum_{g' in chr(g)} x[g'] * k[g'-g]  /  sum_{g' in chr(g)} k[g'-g]

i.e. a per-chromosome convolution with per-position renormalization — one
banded linear operator W over the gene axis.

``BandedGeneOperator`` is generic: the coordinate-window smoother
(``.smooth_helper_by_coordinates`` :2582-2622) produces an arbitrary-band W
and reuses the same machinery.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

LANE = 128  # tile width of the blocked operator layout


def pyramidal_kernel(window_length: int) -> np.ndarray:
    """Triangular numerator weights c(1:t, t+1, t:1) (reference :2647-2650).

    The interior denominator ((w-1)/2)^2 + w equals sum(k), so the
    conv/renorm formulation reproduces the interior exactly as well.
    """
    if window_length % 2 != 1:
        raise ValueError("window_length must be odd")
    t = (window_length - 1) // 2
    return np.concatenate([np.arange(1, t + 1), [t + 1], np.arange(t, 0, -1)]).astype(np.float64)


def boxcar_kernel(window_length: int) -> np.ndarray:
    """Flat weights — caTools::runmean with endrule='mean' semantics
    (reference :2679-2704)."""
    return np.ones(window_length, np.float64)


def _band_from_kernel(chr_ranges: List[Tuple[int, int]], num_genes: int,
                      kernel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Dense band representation of W.

    Returns (band [2t+1, G], halfband t) where band[d + t, g] is the weight
    applied to x[g + d] when producing y[g] (already divided by the
    per-position renormalizer).  Chromosomes with a single gene (or where the
    reference would skip smoothing, nrow<=1, :2418) get identity columns.
    """
    w = kernel.shape[0]
    t = (w - 1) // 2
    band = np.zeros((w, num_genes), np.float64)
    for (b, e) in chr_ranges:
        n = e - b
        if n <= 0:
            continue
        if n == 1:
            band[t, b] = 1.0  # unsmoothed single-gene chromosome
            continue
        for g in range(b, e):
            lo = max(b, g - t)
            hi = min(e, g + t + 1)
            seg = kernel[(lo - g) + t:(hi - g) + t]
            denom = seg.sum()
            band[(lo - g) + t:(hi - g) + t, g] = seg / denom
    return band, t


class BandedGeneOperator:
    """A banded linear operator over the gene axis, in two layouts.

    ``band`` [2t+1, G] (float64): band[d, g] weights x[g + d - t] for y[g].
    ``blocks``: for each 128-column tile j and each tile-shift s in [-S..S],
    a [128, 128] block  B[s][j][r, c] = W[(j+s)*128 + r, j*128 + c],
    so that  y[:, tile j] = sum_s x[:, tile j+s] @ B[s][j].
    """

    def __init__(self, band: np.ndarray, halfband: int, num_genes: int):
        self.band = band
        self.num_genes = num_genes
        self.halfband = halfband
        self.n_tiles = -(-num_genes // LANE)
        self.padded = self.n_tiles * LANE
        S = -(-halfband // LANE) if halfband > 0 else 0
        self.side_tiles = S
        w = band.shape[0]
        blocks = np.zeros((2 * S + 1, self.n_tiles, LANE, LANE), np.float32)
        # scatter band entries into tile blocks
        for d in range(w):  # offset = d - halfband; W[g+off, g]
            off = d - halfband
            cols = np.nonzero(band[d] != 0.0)[0]
            if cols.size == 0:
                continue
            rows = cols + off
            ok = (rows >= 0) & (rows < num_genes)
            cols, rows = cols[ok], rows[ok]
            jt = cols // LANE
            jc = cols % LANE
            rt = rows // LANE
            rr = rows % LANE
            s = rt - jt
            if np.any(np.abs(s) > S):
                raise ValueError("band exceeds side_tiles")
            blocks[s + S, jt, rr, jc] = band[d, cols]
        self.blocks = blocks  # [2S+1, n_tiles, LANE(row of x tile j+s), LANE(col of y tile j)]
        self._shifted = None

    def shifted_blocks(self) -> np.ndarray:
        """Half-lane-shifted weight layout (the K=256 form of the reference):
        w[j, k, c] = W[j*128 - 64 + k, j*128 + c], so
        y[:, tile j] = xpad64[:, j*128 : j*128+256] @ w[j].  Valid when
        halfband <= 64 and side_tiles == 1."""
        if self._shifted is not None:
            return self._shifted
        if self.side_tiles != 1 or self.halfband > 64:
            raise ValueError("shifted layout requires halfband <= 64")
        w = np.zeros((self.n_tiles, 2 * LANE, LANE), np.float32)
        for k in range(2 * LANE):
            off = k - 64                      # global row - j*128 = s*128+rr
            s = (off + LANE) // LANE - 1
            rr = off - s * LANE
            if abs(s) <= self.side_tiles:
                w[:, k, :] = self.blocks[s + self.side_tiles, :, rr, :]
        self._shifted = w
        return w

    def stacked_blocks(self) -> np.ndarray:
        """K=384 aligned layout: w[j] vertically stacks the s = -1, 0, +1
        blocks of output tile j, so y[:, tile j] = xpad128[:, j*128 :
        j*128+384] @ w[j].  Valid whenever side_tiles == 1."""
        if self.side_tiles != 1:
            raise ValueError("stacked layout requires side_tiles == 1")
        return np.concatenate([self.blocks[0], self.blocks[1],
                               self.blocks[2]], axis=1)  # [T, 384, 128]

    def apply_np(self, x: np.ndarray) -> np.ndarray:
        """Reference application on host ([C, G] float64) for tests."""
        C = x.shape[0]
        xp = np.zeros((C, self.padded), x.dtype)
        xp[:, : self.num_genes] = x
        xt = xp.reshape(C, self.n_tiles, LANE)
        out = np.zeros_like(xt)
        S = self.side_tiles
        for s in range(-S, S + 1):
            # x tile index j+s feeds y tile j
            xs = np.zeros_like(xt)
            if s >= 0:
                xs[:, : self.n_tiles - s if s else self.n_tiles] = xt[:, s:]
            else:
                xs[:, -s:] = xt[:, : self.n_tiles + s]
            out += np.einsum("ctg,tgh->cth", xs, self.blocks[s + S].astype(x.dtype))
        return out.reshape(C, self.padded)[:, : self.num_genes]


@functools.lru_cache(maxsize=32)
def _cached_operator(fingerprint, chr_ranges: tuple, num_genes: int,
                     window_length: int, method: str) -> BandedGeneOperator:
    if method == "pyramidinal":
        kernel = pyramidal_kernel(window_length)
    elif method == "runmeans":
        kernel = boxcar_kernel(window_length)
    else:
        raise ValueError(f"unknown smoothing kernel method: {method}")
    band, t = _band_from_kernel(list(chr_ranges), num_genes, kernel)
    return BandedGeneOperator(band, t, num_genes)


def smoothing_operator(gene_order, window_length: int, method: str = "pyramidinal") -> BandedGeneOperator:
    """Build (or fetch cached) the banded smoothing operator for a GeneOrder."""
    return _cached_operator(
        gene_order.fingerprint(), tuple(gene_order.chr_ranges()), gene_order.num_genes,
        window_length, method,
    )


def coordinate_smoothing_operator(gene_order, window_length: int = 10_000_000) -> BandedGeneOperator:
    """Banded operator for the bp-coordinate triangular smoother.

    Reference ``.smooth_helper_by_coordinates`` (R/inferCNV_ops.R:2582-2622):
    for gene i with midpoint p, genes whose [start, stop] lies inside
    (p - L, p + L) get weight 1 - |mid - p|/L; the window is then widened by
    floor(n_around/2) genes on each side with constant weight 0.1 (faithfully
    reproducing the reference's window-extension behavior), clamped to the
    chromosome; y[i] = weighted mean.
    """
    go = gene_order
    G = go.num_genes
    mid = (go.start + go.stop) / 2.0
    max_off = 1
    entries = []  # (g, lo, weights)
    for (b, e) in go.chr_ranges():
        for g in range(b, e):
            p = mid[g]
            inside = np.nonzero((go.start[b:e] > p - window_length) & (go.stop[b:e] < p + window_length))[0] + b
            if inside.size == 0:
                inside = np.array([g])
            to_add = inside.size // 2
            new_lo = max(b, int(inside.min()) - to_add)
            new_hi = min(e - 1, int(inside.max()) + to_add)
            # weights assigned BY POSITION over the contiguous span: the
            # triangular weight lands on its own gene even when `inside`
            # has gaps; gap and extension genes get the 0.1 constant (see
            # the reference layout module for the R recycling bug not copied)
            span_w = np.full(new_hi - new_lo + 1, 0.1)
            span_w[inside - new_lo] = 1.0 - np.abs(mid[inside] - p) / window_length
            entries.append((g, new_lo, span_w / span_w.sum()))
            max_off = max(max_off, g - new_lo, new_hi - g)
    band = np.zeros((2 * max_off + 1, G), np.float64)
    for g, lo, wts in entries:
        for i, wv in enumerate(wts):
            band[(lo + i - g) + max_off, g] = wv
    return BandedGeneOperator(band, max_off, G)
