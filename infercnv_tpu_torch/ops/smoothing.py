"""Chromosome-banded smoothing along the gene axis.

Counterpart of infercnv_tpu/ops/smoothing.py.  ``apply_banded_plain`` is the
tile einsum of ``_apply_banded`` (lines 29-50), the plain version of every
smooth here.  Two wrappers launch CUDA kernels:

* ``apply_banded``: ``csrc/smooth_banded.cu``, one row a block, for
  halfbands up to 64 whose row fits in shared memory.  It replaces the TPU
  kernel ``_smooth_kernel_k256`` (``_apply_banded_pallas_k256``, lines
  74-151) and, given bf16 weights, ``_smooth_kernel_k256_bf16`` (lines
  84-94).
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

reference: smooth_by_chromosome (R/inferCNV_ops.R:2406-2434) and
smooth_by_chromosome_coordinates (:2534-2622).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from infercnv_tpu_torch.ops import _build
from infercnv_tpu_torch.ops.layout import LANE, BandedGeneOperator

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
#: threads a block of the one-row kernels, and outputs a thread (kThreads,
#: kOut of band_smooth.cuh): the one-row smooth needs t4 + 4 <= their product
_ROW_THREADS, _ROW_OUT = 256, 4


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


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


def common_column(band4: np.ndarray):
    """(common [E] f32, slot [round4(G) / 4] i32, edges [n] i32) of a kernel
    band: the column that occurs most often (a smoothing band's interior
    columns are all alike); the "edge" groups, the aligned groups of 4 genes
    with any column that differs from it exactly (near chromosome ends); and
    for each group its place in that list, or -1.  The kernels read the
    common groups' weights from a shared-memory copy of that column."""
    cols, inverse, counts = np.unique(band4.T, axis=0, return_inverse=True,
                                      return_counts=True)
    top = int(counts.argmax())
    common_group = (np.asarray(inverse).reshape(-1, 4) == top).all(axis=1)
    edges = np.nonzero(~common_group)[0].astype(np.int32)
    slot = np.full(common_group.shape[0], -1, np.int32)
    slot[edges] = np.arange(edges.shape[0], dtype=np.int32)
    return np.ascontiguousarray(cols[top], np.float32), slot, edges


@dataclasses.dataclass(frozen=True)
class BandWeights:
    """A smoothing operator on one device, in the layouts its users take."""

    band: torch.Tensor    # [2t+1, G] f32: the operator's band
    band4: torch.Tensor   # kernel_band(band): the CUDA kernels' operand, with
    common: torch.Tensor  # its most common column,
    slot: torch.Tensor    # each 4-gene group's place in edges or -1, and
    edges: torch.Tensor   # the groups that differ from it (common_column)
    tap_lo: torch.Tensor  # [tiles] the general kernel's taps (general_taps)
    tap_hi: torch.Tensor
    max_span: int
    warp_taps: torch.Tensor  # [warps] its warps' taps, lo | hi << 16
    plan: RowPlan         # the fused kernel's (row_plan), numpy arrays
    row: dict             # plan's arrays as tensors on the device
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
        common, slot, edges = common_column(band4)
        tap_lo, tap_hi, max_span, warp_taps = general_taps(band4)
        plan = row_plan(band4, band4_f32, common, op.num_genes,
                        _round4(op.halfband), bf16)

        def dev(a):
            return torch.as_tensor(a).to(device).contiguous()

        return BandWeights(
            band=dev(band), band4=dev(band4), common=dev(common),
            slot=dev(slot), edges=dev(edges), tap_lo=dev(tap_lo),
            tap_hi=dev(tap_hi), max_span=max_span, warp_taps=dev(warp_taps),
            plan=plan,
            row={k: dev(getattr(plan, k)) for k in (
                "common32", "seg", "items", "iscale", "sitems", "sscale",
                "general", "gtaps")},
            blocks=dev(blocks), halfband=op.halfband, n_tiles=op.n_tiles,
            side_tiles=op.side_tiles, num_genes=op.num_genes, bf16=bf16)

    def kernel_args(self):
        """The band as the C entry points take it: band4, common, slot,
        edges, the number of edges."""
        return (_build.ptr(self.band4), _build.ptr(self.common),
                _build.ptr(self.slot), _build.ptr(self.edges),
                int(self.edges.shape[0]))

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
        """Shared memory of a block of the one-row smooth kernel
        (band_smooth_smem_bytes of band_smooth.cuh)."""
        t4 = self.halfband4
        return 4 * ((2 * t4 + 4) + (_round4(self.num_genes) + 2 * t4 + 4)
                    + int(self.edges.shape[0]) * _ROW_OUT)

    def row_kernel_fits(self, smem_optin: int) -> bool:
        """Whether the one-row kernel smooth_banded.cu takes this band and
        row: the smooth's window within a tile of its threads, the block's
        shared memory within the card's opt-in limit."""
        return (self.halfband4 + 4 <= _ROW_THREADS * _ROW_OUT
                and self.row_smem_bytes() <= smem_optin)

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
    tensors launch the kernel, which needs a halfband of at most 64 (the
    TPU kernel's limit) and a row that fits in shared memory."""
    if x.device.type == "cpu":
        return apply_banded_plain(x, w)
    global LAUNCHES, LAUNCHES_BF16
    _check_x("apply_banded", x, w)
    _build.check_inputs("apply_banded", x, w.band4, w.common, w.slot, w.edges)
    lib = _build.library()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.ic_smooth_banded(
            _build.ptr(x), *w.kernel_args(), _build.ptr(y), x.shape[0],
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
