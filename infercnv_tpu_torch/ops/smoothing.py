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

#: genes a block of smooth_general.cu computes (its kTileG)
GENERAL_TILE = 128
#: threads a block of the one-row kernels, and outputs a thread (kThreads,
#: kOut of band_smooth.cuh): the one-row smooth needs t4 + 4 <= their product
_ROW_THREADS, _ROW_OUT = 256, 4


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def round_bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bf16 (ties to even), as f32."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def general_taps(band4: np.ndarray):
    """(tap_lo, tap_hi [n_tiles] i32, max_span) for smooth_general.cu: for
    each tile of GENERAL_TILE genes, the rows of the kernel band holding a
    nonzero weight of the tile, widened to whole float4s, and the widest
    span.  A tile sums only those taps."""
    E, Gr = band4.shape
    n_tiles = -(-Gr // GENERAL_TILE)
    lo = np.zeros(n_tiles, np.int32)
    hi = np.zeros(n_tiles, np.int32)
    for j in range(n_tiles):
        rows = np.nonzero(band4[:, j * GENERAL_TILE:(j + 1) * GENERAL_TILE]
                          .any(axis=1))[0]
        if rows.size:
            lo[j] = rows[0] // 4 * 4
            hi[j] = _round4(int(rows[-1]) + 1)
    return lo, hi, int((hi - lo).max())


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
        blocks = op.blocks
        if bf16:
            band, blocks = round_bf16(band), round_bf16(blocks)
        band4 = kernel_band(band, op.halfband)
        common, slot, edges = common_column(band4)
        tap_lo, tap_hi, max_span = general_taps(band4)

        def dev(a):
            return torch.as_tensor(a).to(device).contiguous()

        return BandWeights(
            band=dev(band), band4=dev(band4), common=dev(common),
            slot=dev(slot), edges=dev(edges), tap_lo=dev(tap_lo),
            tap_hi=dev(tap_hi), max_span=max_span, blocks=dev(blocks),
            halfband=op.halfband, n_tiles=op.n_tiles,
            side_tiles=op.side_tiles, num_genes=op.num_genes, bf16=bf16)

    def kernel_args(self):
        """The band as the C entry points take it: band4, common, slot,
        edges, the number of edges."""
        return (_build.ptr(self.band4), _build.ptr(self.common),
                _build.ptr(self.slot), _build.ptr(self.edges),
                int(self.edges.shape[0]))

    def row_smem_bytes(self) -> int:
        """Shared memory of a block of the one-row smooth kernel
        (band_smooth_smem_bytes of band_smooth.cuh)."""
        t4 = self.halfband4
        return 4 * ((2 * t4 + 4) + (_round4(self.num_genes) + 2 * t4 + 4)
                    + int(self.edges.shape[0]) * _ROW_OUT)

    def row_kernel_fits(self, extra_bytes: int, smem_optin: int) -> bool:
        """Whether a one-row kernel (smooth_banded.cu, or residual_fused.cu
        with its extra_bytes) takes this band and row: the smooth's window
        within a tile of its threads, the block's shared memory within the
        card's opt-in limit."""
        return (self.halfband4 + 4 <= _ROW_THREADS * _ROW_OUT
                and self.row_smem_bytes() + extra_bytes <= smem_optin)

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
    _build.check_inputs("apply_banded_general", x, w.band4, w.tap_lo, w.tap_hi)
    lib = _build.library()
    y = torch.empty_like(x)
    G = w.num_genes
    with torch.cuda.device(x.device):
        rc = lib.ic_smooth_general(
            _build.ptr(x), _build.ptr(w.band4), _build.ptr(w.tap_lo),
            _build.ptr(w.tap_hi), w.max_span, _build.ptr(y), G, x.shape[0], G,
            w.halfband4, _build.stream_of(x))
    _build.check(rc, "smooth_general")
    LAUNCHES_GENERAL += 1
    return y
