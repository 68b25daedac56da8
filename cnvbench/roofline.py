"""Operations and bytes of the port's kernels, and the card's peaks.

Counted from the work a job hands a kernel, not from how the kernel is
launched: each input byte read once, each output byte written once, and
the float32 operations the algorithm needs.  The least time of some work is
the larger of bytes over the memory bandwidth and operations over the
float32 rate; a kernel's roofline share is that least time over the device
time its launches took.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor cores.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
#: float32 operations a (position, state) of the Viterbi: the emission
#: (subtract, abs, divide, the 15-term Horner polynomial, log) ~34 and the
#: forward step's max and add ~6
VITERBI_FLOPS = 40


def least_seconds(nbytes: float, flops: float) -> Tuple[float, str]:
    """(least seconds, what bounds them: "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def residual_fused(rows: int, genes: int, band_nonzeros: int) -> Tuple[float, float]:
    """(bytes, operations) of the fused residual over rows cells: the u16
    counts in, the band's weights and four bound rows, the residual and the
    denoised residual out in float32; two operations a band weight a row
    (the smooth's multiply-add)."""
    nbytes = (rows * genes * 2 + band_nonzeros * 4 + 4 * genes * 4
              + 2 * rows * genes * 4)
    return float(nbytes), 2.0 * band_nonzeros * rows


def viterbi(rows: int, genes: int, states: int) -> Tuple[float, float]:
    """The per-cell Viterbi of rows cells: the float32 residual in, an int8
    state out a gene; VITERBI_FLOPS a (gene, state)."""
    return float(rows * genes * (4 + 1)), float(VITERBI_FLOPS) * rows * genes * states


def smooth(rows: int, genes: int, band_nonzeros: int) -> Tuple[float, float]:
    """A banded smooth: float32 rows in and out, the band's weights; two
    operations a weight a row."""
    return float(2 * rows * genes * 4 + band_nonzeros * 4), 2.0 * band_nonzeros * rows


def row_median(rows: int, genes: int) -> Tuple[float, float]:
    """The exact median of float32 rows: the rows in, a value a row out."""
    return float(rows * genes * 4 + rows * 4), 0.0
