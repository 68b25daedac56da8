"""2-D median filtering within (subcluster x chromosome) blocks, on the
device.

Counterpart of infercnv_tpu/ops/median_filter.py, which runs it on the host
in numpy (reference R/noise_reduction.R apply_median_filtering :43-89 and
.median_filter :92-113).  The reference's neighbourhood of a position is
the square [pos - (half+1), pos + (half+1)] clamped to the block (its edge
rule: positions within half+1 of an edge extend to the edge), and its value
the median of the values inside, as ``np.nanmedian`` gives it over
NaN-padded shifted planes.  Here the same planes are the windows of the
NaN-padded block (``unfold``), sorted with the NaNs last; the valid values
are counted and the two middle ones averaged, as numpy averages them for an
even count (``torch.nanmedian`` returns the lower one), in float64 as the
reference computes, then cast to float32.  The planes are built over
cell-axis chunks with an (half+1)-wide halo, as the reference chunks them, so
a large group's block never holds all its (2r+1)^2 planes at once.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from infercnv_tpu_torch.core.object import InferCNV
from infercnv_tpu_torch.device import DeviceLike, resolve_device


def _median_filter_block_core(data: torch.Tensor, window_size: int) -> torch.Tensor:
    """data: [G_chr, n_cells] float64; the filtered block."""
    r = (window_size - 1) // 2 + 1
    W = 2 * r + 1
    X, Y = data.shape
    padded = F.pad(data[None, None], (r, r, r, r), value=float("nan"))[0, 0]
    win = padded.unfold(0, W, 1).unfold(1, W, 1).reshape(X, Y, W * W)
    vals, _ = torch.sort(win, dim=-1)          # NaNs sort last
    n = (~torch.isnan(win)).sum(dim=-1, keepdim=True)
    lo = torch.gather(vals, -1, torch.clamp((n - 1) // 2, min=0))
    hi = torch.gather(vals, -1, torch.clamp(n // 2, min=0))
    med = (lo + hi) / 2
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))[..., 0]


def _median_filter_block(data, window_size: int,
                         max_plane_elems: int = 20_000_000,
                         device: DeviceLike = None) -> torch.Tensor:
    """data: [G_chr, n_cells] (genes x cells, reference orientation), an
    array or a tensor; returns the filtered block as float64 on ``device``
    (a tensor's own device when None).

    The windows of at most ~max_plane_elems values are built at once: over
    cell-axis chunks with an r-wide halo, which reproduces the whole
    block's result for the chunk's own columns (the edge rule is a clamp to
    the block, so an interior column never reaches the halo's far edge)."""
    if torch.is_tensor(data) and device is None:
        dev = data.device
    else:
        dev = resolve_device(device)
    data = torch.as_tensor(data).to(device=dev, dtype=torch.float64)
    r = (window_size - 1) // 2 + 1
    W = 2 * r + 1
    X, Y = data.shape
    chunk = max(W, max_plane_elems // max(W * W * X, 1))
    if Y <= chunk:
        return _median_filter_block_core(data, window_size)
    out = torch.empty_like(data)
    for c0 in range(0, Y, chunk):
        c1 = min(c0 + chunk, Y)
        h0, h1 = max(0, c0 - r), min(Y, c1 + r)
        sub = _median_filter_block_core(data[:, h0:h1], window_size)
        out[:, c0:c1] = sub[:, c0 - h0:c1 - h0]
    return out


def apply_median_filtering(obj: InferCNV, window_size: int = 7,
                           on_observations: bool = True,
                           on_references: bool = True,
                           device: DeviceLike = None) -> InferCNV:
    """In-place median filtering per (subcluster | reference group) x
    chromosome, on ``device`` (CUDA unless the caller passes "cpu"); the
    object's expr comes back to the host as float32."""
    if window_size % 2 != 1 or window_size < 3:
        # the reference stop()s here (noise_reduction.R:52-54)
        raise ValueError("window_size must be an odd number >= 3")
    dev = resolve_device(device)

    blocks = []
    if on_observations:
        if obj.tumor_subclusters is not None:
            for tumor_type in obj.obs_groups:
                subs = obj.tumor_subclusters["subclusters"].get(
                    tumor_type, {tumor_type: obj.obs_groups[tumor_type]})
                blocks.extend(np.asarray(v) for v in subs.values())
        else:
            blocks.extend(np.asarray(v) for v in obj.obs_groups.values())
    if on_references:
        blocks.extend(np.asarray(v) for v in obj.ref_groups.values())

    expr = torch.as_tensor(np.asarray(obj.expr)).to(device=dev, dtype=torch.float64)
    for cell_idx in blocks:
        if cell_idx.size == 0:
            continue
        rows = torch.as_tensor(cell_idx, dtype=torch.int64, device=dev)
        for (b, e) in obj.gene_order.chr_ranges():
            if e <= b:
                continue
            block = expr[rows, b:e].t()                 # [G_chr, cells]
            expr[rows, b:e] = _median_filter_block(block, window_size).t()
    obj.expr = expr.to(torch.float32).cpu().numpy()
    return obj
