"""Chromosome-banded smoothing along the gene axis.

Counterpart of infercnv_tpu/ops/smoothing.py.  ``apply_banded_plain`` is the
tile einsum of ``_apply_banded`` (lines 29-50), the plain version of every
smooth here.  Two wrappers launch CUDA kernels:

* ``apply_banded``: ``csrc/smooth_banded.cu``, for halfbands up to 64: the
  fused residual kernel's smooth on its row plan (``row_plan``), each row
  split into spans of ``SPAN_COORDS`` coordinates, one block a span
  (``span_plan``).  It replaces the TPU kernel ``_smooth_kernel_k256``
  (``_apply_banded_pallas_k256``, lines 74-151) and, given bf16 weights,
  ``_smooth_kernel_k256_bf16`` (lines 84-94).
* ``apply_banded_general``: ``csrc/smooth_general.cu``, tiles of rows x
  genes, for any band and any number of genes.  It replaces
  ``_smooth_kernel_sides`` (``_apply_banded_pallas_sides``, lines 97-196).

The kernels apply the band directly (``kernel_band``: the ``[2t+1, G]`` band
padded to whole float4s); the plain version multiplies the 128-wide tile
blocks.  Both are f32 products, so they agree to f32 rounding (the sums are
grouped differently).  ``BandWeights(bf16=True)`` holds the weights rounded
to bf16 (the reference's ``matmul_dtype="bfloat16"``): every smooth with
them rounds x to bf16 as well, so each product is exact and only the f32
sums round.

``smooth_by_chromosome``, ``smooth_by_chromosome_coordinates`` (the
reference's lines 214-232) and ``apply_banded_operator`` (lines 53-57)
smooth a matrix on a device with the route the engine takes for the same
band (``smooth_route``): the one-row kernel where it takes the band, else
the tiled one.  ``smooth_window_reference`` is the reference's float64
numpy smoother of one chromosome (lines 235-255), copied.

reference: smooth_by_chromosome (R/inferCNV_ops.R:2406-2434) and
smooth_by_chromosome_coordinates (:2534-2622).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from infercnv_tpu_torch.device import DeviceLike, resolve_device
from infercnv_tpu_torch.ops import _build
from infercnv_tpu_torch.ops.layout import (
    LANE,
    BandedGeneOperator,
    coordinate_smoothing_operator,
    smoothing_operator,
)

#: launches of each CUDA kernel (the plain version does not count):
#: smooth_banded.cu in f32 (TPU kernel 3) and with bf16 operands (kernel 4),
#: and smooth_general.cu (kernel 5)
LAUNCHES = 0
LAUNCHES_BF16 = 0
LAUNCHES_GENERAL = 0

#: genes a block of smooth_general.cu computes (its kTileG), and genes a
#: warp computes (kWarpG): each warp sums only its own nonzero taps
GENERAL_TILE = 128
GENERAL_WARP = 32
#: coordinates of the gapped row a block of smooth_banded.cu smooths (its
#: kSpan: 128 threads, one 8-coordinate item each), and the rows a block of
#: its bf16 variant smooths (kBf16Rows: a scaled weight is rounded once for
#: all of them)
SPAN_COORDS = 1024
BF16_ROWS = 4
#: shared memory a block may opt in to on an H100 (227 KB): the capacity the
#: routes are planned with on the CPU; a CUDA device reports its own
SMEM_OPTIN_BYTES = 232_448


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def swz_row_len(span: int, t4: int) -> int:
    """Floats of a swizzled row of `span` coordinates (swz_row_len of
    csrc/band_smooth.cuh): the coordinates, a halfband of pads either side
    and a float4 beyond, in whole runs of 64."""
    return ((span + 7) // 8 * 8 + 2 * t4 + 16 + 63) // 64 * 64


def round_bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bf16 (ties to even), as f32."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def nonzero_taps(band4: np.ndarray, width: int):
    """(lo, hi) [ceil(round4(G) / width)] i32: for each run of `width`
    columns of a kernel band, the rows holding a nonzero weight of the run,
    widened to whole float4s (multiples of 4; lo = hi = 0 if none)."""
    E, Gr = band4.shape
    n = -(-Gr // width)
    nz = np.zeros((E, n * width), bool)
    nz[:, :Gr] = band4 != 0
    nz = nz.reshape(E, n, width).any(axis=2)
    has = nz.any(axis=0)
    first = np.where(has, nz.argmax(axis=0), 0)
    last = np.where(has, E - 1 - nz[::-1].argmax(axis=0), -1)
    lo = np.where(has, first // 4 * 4, 0).astype(np.int32)
    hi = np.where(has, (last + 4) // 4 * 4, 0).astype(np.int32)
    return lo, hi


def general_taps(band4: np.ndarray):
    """(tap_lo, tap_hi [n_tiles] i32, max_span, warp_taps [n_warps] i32) for
    smooth_general.cu: for each tile of GENERAL_TILE genes the kernel band's
    nonzero taps (nonzero_taps), which the block stages, and the widest
    span; for each run of GENERAL_WARP genes its own nonzero taps, packed
    lo | hi << 16, which its warp sums."""
    lo, hi = nonzero_taps(band4, GENERAL_TILE)
    wlo, whi = nonzero_taps(band4, GENERAL_WARP)
    return lo, hi, int((hi - lo).max()), (wlo | (whi << 16)).astype(np.int32)


def band_segments(band4: np.ndarray, num_genes: int, t4: int) -> np.ndarray:
    """[n + 1] i32: the starts of the runs of genes that the band never
    couples (chromosomes, for a smoothing band), and num_genes.  A cut lies
    before gene b when no column left of b reads x at or right of b and no
    column from b on reads x left of b."""
    G = num_genes
    nz = band4[:, :G] != 0
    has = nz.any(axis=0)
    genes = np.arange(G)
    first = nz.argmax(axis=0)
    last = band4.shape[0] - 1 - nz[::-1].argmax(axis=0)
    low = np.where(has, genes + first - t4, G)         # lowest x read
    high = np.where(has, genes + last - t4, -1)        # highest x read
    b = genes[1:]
    cut = ((np.maximum.accumulate(high)[:-1] < b)
           & (np.minimum.accumulate(low[::-1])[::-1][1:] >= b))
    return np.concatenate([[0], b[cut], [G]]).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """How csrc/residual_fused.cu smooths a row (its struct RowBand).

    The row sits in shared memory with ``gap`` zeros between the band's
    segments (band_segments, each of at least 8 genes): gene g of segment s
    at coordinate o(g) = g + gap * s, its slot o(g) + t4.  Zeros between chromosomes do
    what the band's renormalised chromosome ends do, up to a scale: most
    genes' columns are the common column cut to the gene's own segment,
    times a scale (1 inside a chromosome).  Those are smoothed with the
    common column in items of 8 coordinates, ``(q << 9) | (scaled << 8) |
    mask`` (coordinates 8q + j for the bits j of mask: genes, not gaps),
    with the 8 scales of a scaled item in ``iscale``.  A gene whose column
    is not such a multiple (another band, or a layout without gaps) is
    "general": the kernel reads its column from band4 over its nonzero taps.
    f32: a scaled column is within 2^-20 of its largest weight of
    scale * common (the kernel scales the sum of an item with the scaled
    bit); bf16: it equals bf16(scale * common32) in every weight, as the
    kernel forms it, for the items of ``sitems`` (scales ``sscale``), which
    then leave ``items``."""

    c_lo: int               # the common column's nonzero taps, in float4s
    c_hi: int
    common32: np.ndarray    # [E] the common column of the f32 band
    gap: int                # zeros between segments (0: no gaps)
    seg: np.ndarray         # [nseg + 1] segment starts (band_segments)
    items: np.ndarray       # [n] i32
    iscale: np.ndarray      # [n, 8] f32
    sitems: np.ndarray      # [k] i32: bf16 weights' scaled items
    sscale: np.ndarray      # [k, 8] f32
    general: np.ndarray     # [m, 2] i32: (gene, coordinate)
    gtaps: np.ndarray       # [m] i32: nonzero taps, lo | hi << 16
    span: int               # coordinates of the row: G + gap * (nseg - 1)


def row_plan(band4: np.ndarray, band4_f32: np.ndarray, common: np.ndarray,
             num_genes: int, t4: int, bf16: bool) -> RowPlan:
    """The fused kernel's plan for a kernel band and its common column (see
    RowPlan).  Gaps go between segments unless they would more than double
    the row."""
    G, E = num_genes, band4.shape[0]
    is_common = (band4[:, :G] == common[:, None]).all(axis=0)
    common32 = (band4_f32[:, np.argmax(is_common)] if is_common.any()
                else common).astype(np.float32)
    nz = np.nonzero(common)[0]
    c_lo = int(nz[0]) // 4 * 4 if nz.size else 0
    c_hi = _round4(int(nz[-1]) + 1) if nz.size else 0

    # segments of at least 8 genes (a shorter one joins its left
    # neighbour, with no gap between), so 8 consecutive genes cross at most
    # one segment start
    starts = [0]
    for c in band_segments(band4, G, t4)[1:-1]:
        if c - starts[-1] >= 8:
            starts.append(int(c))
    if len(starts) > 1 and G - starts[-1] < 8:
        starts.pop()
    gap = t4 if (len(starts) - 1) * t4 <= G else 0
    seg = np.array((starts if gap else [0]) + [G], np.int32)
    genes = np.arange(G)
    sid = np.searchsorted(seg, genes, side="right") - 1
    coord = genes + gap * sid
    span = G + gap * (seg.shape[0] - 2)

    # the common column cut to each gene's segment, and each gene's scale
    taps = np.arange(E)[:, None]
    xg = genes[None, :] + taps - t4
    inside = (xg >= seg[sid][None, :]) & (xg < seg[sid + 1][None, :])
    model = np.where(inside & (taps >= c_lo) & (taps < c_hi),
                     common32.astype(np.float64)[:, None], 0.0)
    cols = band4_f32[:, :G].astype(np.float64)
    msum = model.sum(axis=0)
    scale = (cols.sum(axis=0) / np.where(msum != 0, msum, 1.0)).astype(np.float32)
    scale[is_common] = 1.0
    if bf16:
        ok = (round_bf16(scale[None, :] * model.astype(np.float32))
              == band4[:, :G]).all(axis=0)
    else:
        err = np.abs(scale.astype(np.float64) * model - cols).max(axis=0)
        ok = err <= 2.0 ** -20 * np.abs(cols).max(axis=0)
    ok &= (msum != 0) | ~cols.any(axis=0)
    ok |= is_common

    n_q = -(-span // 8)
    gene_at = np.full(n_q * 8, -1, np.int64)
    gene_at[coord[ok]] = genes[ok]
    gq = gene_at.reshape(n_q, 8)
    mask = ((gq >= 0) << np.arange(8)).sum(axis=1)
    sc = np.where(gq >= 0, scale[np.maximum(gq, 0)], 1.0).astype(np.float32)
    scaled_q = (sc != 1.0).any(axis=1)
    item = (np.arange(n_q) << 9) | (scaled_q << 8) | mask
    q = np.nonzero((mask != 0) & ~(scaled_q & bf16))[0]
    sq = np.nonzero((mask != 0) & scaled_q & bf16)[0]

    gen = np.nonzero(~ok)[0]
    lo, hi = nonzero_taps(band4, 1)
    return RowPlan(
        c_lo=c_lo, c_hi=c_hi, common32=common32, gap=gap, seg=seg,
        items=item[q].astype(np.int32), iscale=np.ascontiguousarray(sc[q]),
        sitems=item[sq].astype(np.int32), sscale=np.ascontiguousarray(sc[sq]),
        general=np.stack([gen, coord[gen]], axis=1).astype(np.int32).reshape(-1, 2),
        gtaps=(lo[gen] | (hi[gen] << 16)).astype(np.int32), span=span)


@dataclasses.dataclass(frozen=True)
class SpanPlan:
    """How csrc/smooth_banded.cu splits a row plan's gapped row over blocks
    (its struct SpanBand): span k holds the coordinates [k * SPAN_COORDS,
    (k + 1) * SPAN_COORDS), and its block stages them with t4 coordinates
    of halo either side.  The items (bf16 scaled items, general genes) of
    span k are items[items[k]:items[k + 1]] of the row plan, and seg[k]
    is the segment of the span's first staged coordinate, max(k *
    SPAN_COORDS - t4, 0), from which its threads walk the segment starts."""

    items: np.ndarray    # [nspan + 1] i32
    sitems: np.ndarray   # [nspan + 1] i32
    general: np.ndarray  # [nspan + 1] i32
    seg: np.ndarray      # [nspan] i32

    @property
    def nspan(self) -> int:
        return int(self.seg.shape[0])


def span_plan(plan: RowPlan, t4: int) -> SpanPlan:
    """The spans of a row plan (see SpanPlan): every item lies in the span
    of its 8 coordinates (SPAN_COORDS is a multiple of 8), a general gene in
    the span of its coordinate."""
    nspan = -(-plan.span // SPAN_COORDS)
    starts = np.arange(nspan + 1) * SPAN_COORDS

    def first(coords):
        return np.searchsorted(coords, starts, side="left").astype(np.int32)

    nseg = plan.seg.shape[0] - 1
    seg_start = plan.seg[:-1] + plan.gap * np.arange(nseg)
    staged = np.maximum(starts[:-1] - t4, 0)
    return SpanPlan(
        items=first((plan.items >> 9) * 8), sitems=first((plan.sitems >> 9) * 8),
        general=first(plan.general[:, 1]),
        seg=(np.searchsorted(seg_start, staged, side="right") - 1).astype(np.int32))


def kernel_band(band: np.ndarray, halfband: int) -> np.ndarray:
    """The CUDA kernels' band layout (csrc/band_smooth.cuh): with
    t4 = round4(t), row e weights x[g + e - t4] for y[g], e in [0, 2*t4 + 4);
    the [2t+1, G] band shifted down by t4 - t rows, zero-padded to
    round4(G) columns, so that every tap is a whole float4."""
    t4 = _round4(halfband)
    w, G = band.shape
    out = np.zeros((2 * t4 + 4, _round4(G)), np.float32)
    out[t4 - halfband:t4 - halfband + w, :G] = band
    return out


def common_column(band4: np.ndarray) -> np.ndarray:
    """The column of a kernel band that occurs most often (a smoothing
    band's interior columns are all alike), [E] f32: the row plan's common
    column, which the row kernels hold in shared memory."""
    cols, counts = np.unique(band4.T, axis=0, return_counts=True)
    return np.ascontiguousarray(cols[int(counts.argmax())], np.float32)


@dataclasses.dataclass(frozen=True)
class BandWeights:
    """A smoothing operator on one device, in the layouts its users take."""

    band: torch.Tensor    # [2t+1, G] f32: the operator's band
    band4: torch.Tensor   # kernel_band(band): the CUDA kernels' operand
    common: torch.Tensor  # its most common column (common_column)
    tap_lo: torch.Tensor  # [tiles] the general kernel's taps (general_taps)
    tap_hi: torch.Tensor
    max_span: int
    warp_taps: torch.Tensor  # [warps] its warps' taps, lo | hi << 16
    plan: RowPlan         # the row kernels' (row_plan), numpy arrays
    spans: SpanPlan       # the one-row smooth's split of it (span_plan)
    row: dict             # the arrays of both as tensors on the device
    blocks: torch.Tensor  # [2S+1, n_tiles, 128, 128] f32: the plain version's
    halfband: int
    n_tiles: int
    side_tiles: int
    num_genes: int
    bf16: bool            # weights rounded to bf16; x is rounded too

    @property
    def halfband4(self) -> int:
        """The halfband rounded up to a multiple of 4 (the kernels' t4)."""
        return _round4(self.halfband)

    @staticmethod
    def from_operator(op: BandedGeneOperator, device,
                      bf16: bool = False) -> "BandWeights":
        band = np.asarray(op.band, np.float32)
        band4_f32 = kernel_band(band, op.halfband)
        blocks = op.blocks
        if bf16:
            band, blocks = round_bf16(band), round_bf16(blocks)
        band4 = kernel_band(band, op.halfband) if bf16 else band4_f32
        common = common_column(band4)
        tap_lo, tap_hi, max_span, warp_taps = general_taps(band4)
        plan = row_plan(band4, band4_f32, common, op.num_genes,
                        _round4(op.halfband), bf16)
        spans = span_plan(plan, _round4(op.halfband))

        def dev(a):
            return torch.as_tensor(a).to(device).contiguous()

        row = {k: dev(getattr(plan, k)) for k in (
            "common32", "seg", "items", "iscale", "sitems", "sscale",
            "general", "gtaps")}
        row.update({f"span_{k}": dev(getattr(spans, k))
                    for k in ("items", "sitems", "general", "seg")})
        return BandWeights(
            band=dev(band), band4=dev(band4), common=dev(common),
            tap_lo=dev(tap_lo), tap_hi=dev(tap_hi), max_span=max_span,
            warp_taps=dev(warp_taps), plan=plan, spans=spans, row=row,
            blocks=dev(blocks), halfband=op.halfband, n_tiles=op.n_tiles,
            side_tiles=op.side_tiles, num_genes=op.num_genes, bf16=bf16)

    @functools.cached_property
    def span_args(self):
        """The band as csrc/smooth_banded.cu takes it (struct SpanBand):
        band4, common, common32, c_lo, c_hi, gap, the segment starts and
        their number, the items and their scales, the bf16 scaled items and
        their scales, the general genes and their taps, span, the spans'
        first items, scaled items, general genes and segments, their number,
        SPAN_COORDS."""
        p, r = self.plan, self.row
        return (_build.ptr(self.band4), _build.ptr(self.common),
                _build.ptr(r["common32"]), p.c_lo, p.c_hi, p.gap,
                _build.ptr(r["seg"]), int(p.seg.shape[0]) - 1,
                _build.ptr(r["items"]), _build.ptr(r["iscale"]),
                _build.ptr(r["sitems"]), _build.ptr(r["sscale"]),
                _build.ptr(r["general"]), _build.ptr(r["gtaps"]), p.span,
                *(_build.ptr(r[f"span_{k}"]) for k in
                  ("items", "sitems", "general", "seg")),
                self.spans.nspan, SPAN_COORDS)

    def fused_args(self):
        """The band as csrc/residual_fused.cu takes it (struct RowBand):
        band4, common, common32, c_lo, c_hi, gap, the segment starts and
        their number, the items, their scales and number, the bf16 scaled
        items, their scales and number, the general genes, their taps and
        number, span."""
        p, r = self.plan, self.row
        return (_build.ptr(self.band4), _build.ptr(self.common),
                _build.ptr(r["common32"]), p.c_lo, p.c_hi, p.gap,
                _build.ptr(r["seg"]), int(p.seg.shape[0]) - 1,
                _build.ptr(r["items"]), _build.ptr(r["iscale"]),
                int(p.items.shape[0]), _build.ptr(r["sitems"]),
                _build.ptr(r["sscale"]), int(p.sitems.shape[0]),
                _build.ptr(r["general"]), _build.ptr(r["gtaps"]),
                int(p.general.shape[0]), p.span)

    def general_args(self, x: torch.Tensor):
        """x and the band as csrc/smooth_general.cu takes them: x, band4,
        tap_lo, tap_hi, warp_taps, max_span."""
        return (_build.ptr(x), _build.ptr(self.band4), _build.ptr(self.tap_lo),
                _build.ptr(self.tap_hi), _build.ptr(self.warp_taps),
                self.max_span)

    def row_smem_bytes(self) -> int:
        """Shared memory of a block of the one-row smooth (span_smem_bytes
        of csrc/smooth_banded.cu): the common column (and its f32 form with
        bf16 weights), and for each of its rows (BF16_ROWS with bf16
        weights, else one) a span's window with its halo and the span's
        outputs."""
        t4 = self.halfband4
        rows = BF16_ROWS if self.bf16 else 1
        return 4 * ((2 if self.bf16 else 1) * (2 * t4 + 4)
                    + rows * (swz_row_len(SPAN_COORDS, t4) + SPAN_COORDS))

    def row_kernel_fits(self, smem_optin: int) -> bool:
        """Whether the engine's one-row route takes this band: a block of
        smooth_banded.cu within the card's opt-in limit, and a gapped row
        that one block could hold whole (the common columns and the
        swizzled row, as the fused kernel holds it).  The kernel splits a
        row over blocks and would take any width; the second condition
        keeps a genome too wide for the fused kernel (60,000 genes) on the
        tiled kernel 5 with the rest of its route (ROADMAP queue D)."""
        t4 = self.halfband4
        whole_row = 4 * (2 * (2 * t4 + 4) + swz_row_len(self.plan.span, t4))
        return (self.row_smem_bytes() <= smem_optin
                and whole_row <= smem_optin)

    def dense(self) -> torch.Tensor:
        """The [G, G] operator W with y = x @ W (a yardstick only: 285 MB
        at 8448 genes)."""
        G, t = self.num_genes, self.halfband
        W = torch.zeros((G, G), dtype=torch.float32, device=self.band.device)
        cols = torch.arange(G, device=self.band.device)
        for d in range(2 * t + 1):
            rows = cols + d - t
            ok = (rows >= 0) & (rows < G)
            W[rows[ok], cols[ok]] = self.band[d, ok]
        return W


def apply_banded_plain(x: torch.Tensor, w: BandWeights) -> torch.Tensor:
    """y[:, tile j] = sum_s x[:, tile j+s] @ blocks[s][j].  x: [C, G] f32;
    with bf16 weights x is rounded to bf16 first.

    The f32 products are summed in float64 and rounded once: a CPU BLAS may
    group an f32 sum differently from one call to the next, which would
    make the plain version irreproducible in its last bit."""
    if w.bf16:
        x = x.to(torch.bfloat16).to(torch.float32)
    C = x.shape[0]
    T, S = w.n_tiles, w.side_tiles
    xp = torch.zeros((C, T * LANE), dtype=torch.float64, device=x.device)
    xp[:, :w.num_genes] = x
    xt = xp.reshape(C, T, LANE)
    out = torch.zeros_like(xt)
    for s in range(-S, S + 1):
        if s == 0:
            xs = xt
        elif s > 0:
            xs = torch.cat([xt[:, s:], xt.new_zeros((C, s, LANE))], dim=1)
        else:
            xs = torch.cat([xt.new_zeros((C, -s, LANE)), xt[:, :s]], dim=1)
        out = out + torch.einsum("ctg,tgh->cth", xs, w.blocks[s + S].double())
    return out.reshape(C, T * LANE)[:, :w.num_genes].to(torch.float32)


def _check_x(name: str, x: torch.Tensor, w: BandWeights) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != w.num_genes:
        raise ValueError(f"{name}: need f32 [C, {w.num_genes}], got "
                         f"{x.dtype} {tuple(x.shape)}")


def apply_banded(x: torch.Tensor, w: BandWeights) -> torch.Tensor:
    """Banded smooth of x [C, G] f32 by the one-row kernel (f32, or bf16
    operands with bf16 weights).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (the engine takes it for halfbands of at most
    64, the TPU kernel's limit, where row_kernel_fits)."""
    if x.device.type == "cpu":
        return apply_banded_plain(x, w)
    global LAUNCHES, LAUNCHES_BF16
    _check_x("apply_banded", x, w)
    _build.check_inputs("apply_banded", x, w.band4)   # w's tensors: one device
    lib = _build.library()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.ic_smooth_banded(
            _build.ptr(x), *w.span_args, _build.ptr(y), x.shape[0],
            w.num_genes, w.halfband4, int(w.bf16), _build.stream_of(x))
    _build.check(rc, "smooth_banded")
    if w.bf16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    return y


def apply_banded_general(x: torch.Tensor, w: BandWeights) -> torch.Tensor:
    """Banded smooth of x [C, G] f32 for any band and any G, by the tiled
    kernel.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (with bf16 weights, x is first rounded to bf16 by a PyTorch
    cast)."""
    if x.device.type == "cpu":
        return apply_banded_plain(x, w)
    global LAUNCHES_GENERAL
    _check_x("apply_banded_general", x, w)
    if w.bf16:
        x = x.to(torch.bfloat16).to(torch.float32)
    _build.check_inputs("apply_banded_general", x, w.band4, w.tap_lo, w.tap_hi,
                        w.warp_taps)
    lib = _build.library()
    y = torch.empty_like(x)
    G = w.num_genes
    with torch.cuda.device(x.device):
        rc = lib.ic_smooth_general(*w.general_args(x), _build.ptr(y), G,
                                   x.shape[0], G, w.halfband4,
                                   _build.stream_of(x))
    _build.check(rc, "smooth_general")
    LAUNCHES_GENERAL += 1
    return y


def smooth_route(w: BandWeights, smem_optin: int) -> str:
    """The smooth a band takes: "row" (one row a block, smooth_banded.cu)
    for halfbands of at most 64 where the row kernel fits the card, else
    "general" (smooth_general.cu)."""
    return ("row" if w.side_tiles == 1 and w.halfband <= 64
            and w.row_kernel_fits(smem_optin) else "general")


def card_smem(device: torch.device) -> int:
    """Opt-in shared memory of a CUDA device; the H100's on the CPU."""
    return (_build.max_smem_optin(device) if device.type == "cuda"
            else SMEM_OPTIN_BYTES)


#: (band key, device) -> (BandWeights, route) of smooth_by_chromosome*
_WEIGHTS: dict = {}


def _device_of(x, device: DeviceLike) -> torch.device:
    return x.device if torch.is_tensor(x) and device is None else resolve_device(device)


def _apply_route(x, w: BandWeights, route: str, dev: torch.device) -> torch.Tensor:
    x = (x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x, np.float32)))
    x = x.to(device=dev, dtype=torch.float32).contiguous()
    return apply_banded(x, w) if route == "row" else apply_banded_general(x, w)


def _smooth_with(x, key, op_fn, device: DeviceLike) -> torch.Tensor:
    dev = _device_of(x, device)
    hit = _WEIGHTS.get((key, dev))
    if hit is None:
        if len(_WEIGHTS) >= 16:
            _WEIGHTS.clear()
        w = BandWeights.from_operator(op_fn(), dev)
        hit = _WEIGHTS[(key, dev)] = (w, smooth_route(w, card_smem(dev)))
    return _apply_route(x, *hit, dev)


def apply_banded_operator(x, op: BandedGeneOperator,
                          device: DeviceLike = None) -> torch.Tensor:
    """x [C, G] smoothed by a BandedGeneOperator (reference
    infercnv_tpu/ops/smoothing.py:53-57), on the route the engine takes for
    its band (smooth_route).  Runs on `device` (a tensor's own device when
    None; CUDA for a numpy input)."""
    dev = _device_of(x, device)
    w = BandWeights.from_operator(op, dev)
    return _apply_route(x, w, smooth_route(w, card_smem(dev)), dev)


def smooth_by_chromosome(x, gene_order, window_length: int = 101,
                         method: str = "pyramidinal",
                         device: DeviceLike = None) -> torch.Tensor:
    """Smooth [C, G] expression along the genomically ordered gene axis
    (reference infercnv_tpu/ops/smoothing.py:214-226).

    method: 'pyramidinal' (triangular window, renormalized at chromosome
    ends) or 'runmeans' (flat window, same end handling).  Runs on `device`
    (a tensor's own device when None; CUDA for a numpy input)."""
    key = ("window", gene_order.fingerprint(), window_length, method)
    return _smooth_with(
        x, key, lambda: smoothing_operator(gene_order, window_length, method),
        device)


def smooth_by_chromosome_coordinates(x, gene_order,
                                     window_length: int = 10_000_000,
                                     device: DeviceLike = None) -> torch.Tensor:
    """The bp-coordinate triangular smoother (reference
    infercnv_tpu/ops/smoothing.py:229-231); a wide band, so the tiled
    kernel."""
    key = ("coordinates", gene_order.fingerprint(), window_length)
    return _smooth_with(
        x, key, lambda: coordinate_smoothing_operator(gene_order, window_length),
        device)


def smooth_window_reference(x_gc: np.ndarray, window_length: int) -> np.ndarray:
    """Direct float64 implementation of the single-chromosome smoother on a
    [G, C] matrix (the orientation the reference's .smooth_window uses).

    y[g] = sum k[d] x[g+d] / sum k[d] over in-range taps — algebraically
    identical to .smooth_helper's interior filter + end renormalization
    (denominator ((w-1)/2)^2 + w - r_l(r_l+1)/2 - r_r(r_r+1)/2 equals the sum
    of the included triangular weights).

    Copied from infercnv_tpu/ops/smoothing.py:235-255 (numpy, no JAX).
    """
    if window_length < 2:
        return x_gc.copy()
    t = (window_length - 1) // 2
    k = np.concatenate([np.arange(1, t + 1), [t + 1], np.arange(t, 0, -1)]).astype(np.float64)
    G = x_gc.shape[0]
    out = np.empty_like(x_gc, np.float64)
    for g in range(G):
        lo = max(0, g - t)
        hi = min(G, g + t + 1)
        seg = k[(lo - g) + t:(hi - g) + t]
        out[g] = (x_gc[lo:hi].T @ seg) / seg.sum()
    return out
