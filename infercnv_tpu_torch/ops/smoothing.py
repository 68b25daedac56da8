"""Chromosome-banded smoothing along the gene axis.

Counterpart of infercnv_tpu/ops/smoothing.py: ``apply_banded_plain`` is the
tile einsum of ``_apply_banded`` (lines 29-50), and ``apply_banded`` is the
wrapper of the CUDA kernel ``csrc/smooth_banded.cu``, which replaces the TPU
kernel ``_smooth_kernel_k256`` (``_apply_banded_pallas_k256``, lines
74-151).  The kernel applies the band directly (``kernel_band``: the
``[2t+1, G]`` band padded to whole float4s); the plain version multiplies
the 128-wide tile blocks.  Both are f32 products, so
they agree to f32 rounding (the sums are grouped differently).

reference: smooth_by_chromosome (R/inferCNV_ops.R:2406-2434).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from infercnv_tpu_torch.ops import _build
from infercnv_tpu_torch.ops.layout import LANE, BandedGeneOperator

#: launches of the CUDA kernel (the plain version does not count)
LAUNCHES = 0


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


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
    blocks: torch.Tensor  # [2S+1, n_tiles, 128, 128] f32: the plain version's
    halfband: int
    n_tiles: int
    side_tiles: int
    num_genes: int

    @property
    def halfband4(self) -> int:
        """The halfband rounded up to a multiple of 4 (the kernels' t4)."""
        return _round4(self.halfband)

    @staticmethod
    def from_operator(op: BandedGeneOperator, device) -> "BandWeights":
        band4 = kernel_band(op.band, op.halfband)
        common, slot, edges = common_column(band4)
        return BandWeights(
            band=torch.as_tensor(op.band, dtype=torch.float32).to(device).contiguous(),
            band4=torch.as_tensor(band4).to(device),
            common=torch.as_tensor(common).to(device),
            slot=torch.as_tensor(slot).to(device),
            edges=torch.as_tensor(edges).to(device),
            blocks=torch.as_tensor(op.blocks).to(device),
            halfband=op.halfband, n_tiles=op.n_tiles,
            side_tiles=op.side_tiles, num_genes=op.num_genes)

    def kernel_args(self):
        """The band as the C entry points take it: band4, common, slot,
        edges, the number of edges."""
        return (_build.ptr(self.band4), _build.ptr(self.common),
                _build.ptr(self.slot), _build.ptr(self.edges),
                int(self.edges.shape[0]))

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
    """y[:, tile j] = sum_s x[:, tile j+s] @ blocks[s][j].  x: [C, G] f32.

    The f32 products are summed in float64 and rounded once: a CPU BLAS may
    group an f32 sum differently from one call to the next, which would
    make the plain version irreproducible in its last bit."""
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


def apply_banded(x: torch.Tensor, w: BandWeights) -> torch.Tensor:
    """Banded smooth of x [C, G] f32.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return apply_banded_plain(x, w)
    global LAUNCHES
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != w.num_genes:
        raise ValueError(f"apply_banded: need f32 [C, {w.num_genes}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    _build.check_inputs("apply_banded", x, w.band4, w.common, w.slot, w.edges)
    lib = _build.library()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.ic_smooth_banded(
            _build.ptr(x), *w.kernel_args(), _build.ptr(y), x.shape[0],
            w.num_genes, w.halfband4, _build.stream_of(x))
    _build.check(rc, "smooth_banded")
    LAUNCHES += 1
    return y
