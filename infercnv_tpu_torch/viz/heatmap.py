"""CNV heatmap — the port of plot_cnv, with its data side on the device.

Counterpart of infercnv_tpu/viz/heatmap.py (lines 1-752), analogue of the
reference's plot_cnv (R/inferCNV_heatmap.R:90-470 and the vendored heatmap
engine :1374-2768).  ``plot_cnv`` keeps the JAX package's signature and
adds ``device``; it runs in two parts:

* the data side (``heatmap_data``), PyTorch on ``device`` (CUDA unless the
  caller passes ``"cpu"``): the centre (:403-411, summed in float64), the
  1%/99% range (``get_x_range_auto``, :26-39: two exact order statistics a
  quantile found by a chunked radix select, interpolated on the host as
  numpy's ``"linear"`` method does, so ``torch.quantile``'s 2^24-element
  limit does not arise), the row orders and linkages
  (``_group_cell_order_impl`` :133-176, the ``k_obs_groups`` split
  :451-487; the distances through subcluster/distance.py, the PC1 power
  iteration's products as ``torch.matmul``), the display panes
  (``_pane_matrix_dense`` :195-226, ``_pane_matrix_rows`` :229-254: each
  source row clipped and added into its display bin with ``index_add_``)
  and the key's histogram (:674-684, numpy's bin rule).  The [C, G] matrix
  stays on the host and is only read, in chunks of at most 2^24 elements
  (through two pinned buffers on CUDA); nothing full-size is written, on
  the device or on the host.  ``EXACT_STATS_MAX_ELEMS``, ``ORDER_LINKAGE_MAX``,
  the ``row_order_cache`` keys and the sampled-statistics rule are the
  JAX package's, so the card and the CPU take the same branches.
* the host part, copied: the Ward/complete linkage (scipy),
  ``_bp_scale_matrix`` (on display panes of at most ~2,000 rows), the text
  outputs (:700-751, written before the figure: they do not depend on it)
  and the matplotlib figure (:537-697).

Layout mirrors the reference: a chromosome color bar on top, the
observation (tumor) pane with per-group separators and dendrogram-derived
row ordering, reference pane(s) below, blue-white-red palette centered on
x.center with x.range auto-derived from the 1%/99% quantiles of
off-center values (:155-167).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from infercnv_tpu_torch.core.object import InferCNV
from infercnv_tpu_torch.device import DeviceLike, resolve_device
from infercnv_tpu_torch.report.regions import write_expr_matrix
from infercnv_tpu_torch.utils.logging import log_info, log_warn

#: Full-matrix exact statistics (quantile x_range, histogram) are computed
#: only below this many elements; above it they come from a seeded row
#: sample / the display rows (logged).
EXACT_STATS_MAX_ELEMS = 200_000_000

#: Per-block row-ordering switches from O(n^2) Ward linkage to a 1-D
#: principal-component ordering above this many cells (the drawn dendrogram
#: is omitted for such blocks).
ORDER_LINKAGE_MAX = 3000

#: bins of the key's density histogram
HIST_BINS = 50

#: elements of one streamed block of rows (64 MB of float32)
CHUNK_ELEMS = 1 << 24

#: R hclust method names -> scipy linkage methods (reference accepts the R
#: set via plot_cnv(hclust_method=...), inferCNV_heatmap.R:103,117-118)
R_TO_SCIPY_LINKAGE = {
    "ward.D": "ward", "ward.D2": "ward", "ward": "ward",
    "complete": "complete", "average": "average", "single": "single",
    "centroid": "centroid", "median": "median", "mcquitty": "weighted",
    "weighted": "weighted",
}

CHR_BAR_COLORS = [
    "#8DD3C7", "#FFFFB3", "#BEBADA", "#FB8072", "#80B1D3", "#FDB462",
    "#B3DE69", "#FCCDE5", "#D9D9D9", "#BC80BD", "#CCEBC5", "#FFED6F",
]


def color_palette(color_safe: bool = False):
    """Blue-white-red ramp (reference color.palette inferCNV_ops.R:1808-1835:
    'darkblue', 'white', 'darkred'); color_safe uses the colorblind-safe
    purple-white-green ramp (reference plot_cnv color_safe_pal).  Copied
    from infercnv_tpu/viz/heatmap.py:42-52."""
    from matplotlib.colors import LinearSegmentedColormap

    if color_safe:
        return LinearSegmentedColormap.from_list(
            "infercnv_safe", ["#40004B", "#FFFFFF", "#00441B"], N=255)
    return LinearSegmentedColormap.from_list(
        "infercnv", ["#00008B", "#FFFFFF", "#8B0000"], N=255)


# ---------------------------------------------------------------- rows ----

class _Rows:
    """Blocks of rows of a host [C, G] matrix on the device: contiguous
    blocks in row order (``chunks``) or the rows of an index list
    (``gather``), at most CHUNK_ELEMS elements a block, in the matrix's own
    dtype.  On CUDA each block is staged in one of two pinned buffers and
    copied asynchronously, so the host staging of block i+1 overlaps the
    copy and the work of block i (as the pipeline's _stream_cuda does)."""

    def __init__(self, src, device: torch.device):
        self.src = src
        self.dev = device
        self.rows = max(1, CHUNK_ELEMS // max(int(src.shape[1]), 1))
        self._pins: Optional[List[torch.Tensor]] = None
        self._free: List[Optional[torch.cuda.Event]] = [None, None]

    def _upload(self, blocks: Iterable[Tuple[int, np.ndarray]]):
        if self.dev.type != "cuda":
            for b, h in blocks:
                yield b, torch.from_numpy(np.ascontiguousarray(h))
            return
        if self._pins is None:
            dt = torch.from_numpy(np.asarray(self.src[:0])).dtype
            n = self.rows * int(self.src.shape[1])
            self._pins = [torch.empty(n, dtype=dt, pin_memory=True) for _ in range(2)]
        for i, (b, h) in enumerate(blocks):
            s = i % 2
            if self._free[s] is not None:
                self._free[s].synchronize()   # block i-2's copy left the buffer
            pin = self._pins[s][:h.size].view(h.shape)
            pin.copy_(torch.from_numpy(np.ascontiguousarray(h)))
            d = pin.to(self.dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._free[s] = ev
            yield b, d

    def chunks(self):
        """(first row, block) over every row in order."""
        C = self.src.shape[0]
        return self._upload((b, self.src[b:b + self.rows])
                            for b in range(0, C, self.rows))

    def gather(self, idx: np.ndarray, cols: Optional[np.ndarray] = None) -> torch.Tensor:
        """The rows idx (columns cols) as one float32 tensor on the device."""
        idx = np.asarray(idx)
        G = self.src.shape[1] if cols is None else cols.size
        out = torch.empty((idx.size, G), dtype=torch.float32, device=self.dev)

        def blocks():
            for p in range(0, idx.size, self.rows):
                h = self.src[idx[p:p + self.rows]]
                yield p, (h if cols is None else h[:, cols])

        for p, d in self._upload(blocks()):
            out[p:p + d.shape[0]] = d
        return out


def _mean(rows: _Rows) -> float:
    """np.mean of the matrix as float32 values, the sum taken in float64 on
    the device (numpy's float32 pairwise sum rounds otherwise), as a
    float32 value, the dtype numpy's mean has."""
    total = torch.zeros((), dtype=torch.float64, device=rows.dev)
    for _b, x in rows.chunks():
        total += x.to(torch.float32).sum(dtype=torch.float64)
    return float(np.float32(float(total) / max(rows.src.size, 1)))


def expr_mean(expr, device: DeviceLike = None) -> float:
    """The centre of a [C, G] matrix (see _mean) on `device`."""
    return _mean(_rows_of(expr, resolve_device(device)))


def _rows_of(x, device: torch.device) -> _Rows:
    """A _Rows over a host array (as rows of its first axis; a vector as
    one value a row), or over a tensor moved to the host."""
    x = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return _Rows(x.reshape(-1, 1) if x.ndim <= 1 else x.reshape(x.shape[0], -1),
                 device)


# ------------------------------------------------------ order statistics ---

def _f32_keys(x: torch.Tensor) -> torch.Tensor:
    """int32 keys whose bits, read as unsigned, order like the float32
    values: a negative value's bits inverted, a positive value's sign bit
    set."""
    b = x.contiguous().view(torch.int32)
    return torch.where(b < 0, ~b, b ^ torch.iinfo(torch.int32).min)


def _key_value(key: int) -> np.float32:
    b = key - (1 << 31) if key >= (1 << 31) else -1 - key
    return np.array([b], np.int64).astype(np.int32).view(np.float32)[0]


def _order_stats(blocks: Callable[[], Iterable[torch.Tensor]],
                 center: Optional[float],
                 ranks_of: Callable[[int], Sequence[int]]):
    """Exact order statistics of the float32 values of `blocks` that differ
    from `center`: a radix select over the values' 32-bit keys, 16 bits a
    pass — one histogram pass of the high halves (which also counts the
    values, n), then one of the low halves inside the buckets that the
    ranks ``ranks_of(n)`` (0-based, of the sorted values) fall in.  `blocks`
    is called once a pass.  Returns ({rank: value}, n)."""
    def keys(x):
        x = x.reshape(-1).to(torch.float32)
        if center is not None:
            x = x[x != torch.tensor(np.float32(center), device=x.device)]
        return _f32_keys(x)

    hi_hist = None
    for x in blocks():
        h = torch.bincount((keys(x) >> 16) & 0xFFFF, minlength=1 << 16)
        hi_hist = h if hi_hist is None else hi_hist + h
    if hi_hist is None:
        return {}, 0
    hi_hist = hi_hist.cpu().numpy()
    n = int(hi_hist.sum())
    if n == 0:
        return {}, 0
    hi_cum = np.cumsum(hi_hist)
    where = {}
    for r in ranks_of(n):
        bucket = int(np.searchsorted(hi_cum, r, side="right"))
        where[r] = (bucket, r - int(hi_cum[bucket] - hi_hist[bucket]))
    buckets = sorted({b for b, _ in where.values()})
    lo_hist = dict.fromkeys(buckets)
    for x in blocks():
        k = keys(x)
        hi = (k >> 16) & 0xFFFF
        for b in buckets:
            h = torch.bincount(k[hi == b] & 0xFFFF, minlength=1 << 16)
            lo_hist[b] = h if lo_hist[b] is None else lo_hist[b] + h
    out = {}
    for r, (b, within) in where.items():
        lo_cum = np.cumsum(lo_hist[b].cpu().numpy())
        low = int(np.searchsorted(lo_cum, within, side="right"))
        out[r] = _key_value((b << 16) | low)
    return out, n


def _linear_quantile(n: int, q: float, value_at: Callable[[int], np.float32]):
    """numpy's "linear" quantile of n sorted float32 values from two of them,
    with numpy's own float32 arithmetic (numpy/lib/_function_base_impl.py:
    ``quantile`` casts a Python q to the array's dtype; ``_get_indexes``,
    ``_get_gamma``, ``_lerp``)."""
    v = (n - 1) * np.asanyarray(q, dtype=np.float32)
    if v >= n - 1:
        i_prev = i_next = n - 1
        prev = np.asanyarray(-1, dtype=np.intp)
    elif v < 0:
        i_prev = i_next = 0
        prev = np.asanyarray(0, dtype=np.intp)
    else:
        prev = np.floor(v).astype(np.intp)
        i_prev, i_next = int(prev), int(prev) + 1
    gamma = np.asanyarray(v - prev, dtype=v.dtype)
    a = np.asanyarray(value_at(i_prev), dtype=np.float32)
    b = np.asanyarray(value_at(i_next), dtype=np.float32)
    diff = np.subtract(b, a)
    res = np.asanyarray(np.add(a, diff * gamma))
    if gamma >= 0.5:
        res = np.asanyarray(np.subtract(b, diff * (1 - gamma)))
    return res[()]


def _quantile_ranks(n: int, q: float) -> List[int]:
    """The sorted positions _linear_quantile reads."""
    v = (n - 1) * np.asanyarray(q, dtype=np.float32)
    if v >= n - 1:
        return [n - 1]
    if v < 0:
        return [0]
    p = int(np.floor(v))
    return [p, p + 1]


def _x_range(blocks: Callable[[], Iterable[torch.Tensor]],
             x_center: float) -> Tuple[float, float]:
    """get_x_range_auto over the values of `blocks` (two passes)."""
    vals, n = _order_stats(blocks, x_center, lambda n: sorted(
        set(_quantile_ranks(n, 0.01) + _quantile_ranks(n, 0.99))))
    if n == 0:
        return x_center - 1.0, x_center + 1.0
    lo = _linear_quantile(n, 0.01, vals.__getitem__)
    hi = _linear_quantile(n, 0.99, vals.__getitem__)
    # the JAX package's arithmetic, on numpy float32 scalars (:34-39)
    delta = max(abs(lo - x_center), abs(hi - x_center))
    low = x_center - delta
    high = x_center + delta
    if low == high:
        low, high = x_center - 1, x_center + 1
    return float(low), float(high)


def get_x_range_auto(expr_cg, x_center: float,
                     device: DeviceLike = None) -> Tuple[float, float]:
    """1% / 99% quantiles of values away from the center, symmetrized
    (reference inferCNV_heatmap.R:155-167), over expr_cg's values as
    float32, computed on `device` (a tensor's own device when None)."""
    if torch.is_tensor(expr_cg) and device is None:
        t = expr_cg
        return _x_range(lambda: [t], x_center)
    rows = _rows_of(expr_cg, resolve_device(device))
    return _x_range(lambda: (x for _b, x in rows.chunks()), x_center)


# ----------------------------------------------------------- histogram ---

class _Histogram:
    """np.histogram(np.clip(x, lo, hi), bins, range=(lo, hi), weights=w)
    accumulated over blocks (``add``), with numpy's bin rule
    (numpy/lib/_histograms_impl.py, the uniform-bins branch): the index
    from (x - lo) in float32 over (hi - lo) in float64, then corrected
    against the float32 edges."""

    def __init__(self, lo: float, hi: float, bins: int = HIST_BINS):
        self.lo32, self.hi32 = np.float32(lo), np.float32(hi)
        self.bins = bins
        self.edges = np.linspace(lo, hi, bins + 1,
                                 dtype=np.result_type(lo, hi, np.float32))
        self.denom = float(np.subtract(hi, lo, dtype=np.float64))
        self.counts: Optional[torch.Tensor] = None

    def add(self, x: torch.Tensor, w: Optional[torch.Tensor] = None) -> None:
        dev = x.device
        x = torch.clamp(x.reshape(-1).to(torch.float32),
                        float(self.lo32), float(self.hi32))
        e = torch.from_numpy(self.edges).to(dev)
        f = (x - torch.tensor(self.lo32, device=dev)).to(torch.float64) \
            / self.denom * self.bins
        idx = f.to(torch.int64)
        idx[idx == self.bins] -= 1
        idx -= (x < e[idx]).to(torch.int64)
        idx += ((x >= e[idx + 1]) & (idx != self.bins - 1)).to(torch.int64)
        c = torch.bincount(idx, minlength=self.bins, weights=None if w is None
                           else w.reshape(-1).to(torch.float64))
        self.counts = c if self.counts is None else self.counts + c

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        """(counts: int64, or float64 sums of the weights; float32 edges)."""
        if self.counts is None:
            return np.zeros(self.bins, np.int64), self.edges
        return self.counts.cpu().numpy(), self.edges


# ---------------------------------------------------------------- order ---

def _pc1_projection(x: torch.Tensor, iters: int = 12, seed: int = 0):
    """Projections of the rows of x (float32 [n, G], centred here in place)
    on the first principal component, by the JAX package's power iteration
    (:68-82: the start vector drawn from numpy's default_rng(seed)).
    Returns None when the iteration collapses to zero."""
    x -= x.mean(dim=0, keepdim=True)
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.standard_normal(x.shape[1]).astype(np.float32)).to(x.device)
    for _ in range(iters):
        v = x.T @ (x @ v)
        nv = torch.linalg.vector_norm(v)
        if float(nv) == 0:
            return None
        v = v / nv
    return x @ v


def _pc1_order(x_cg, iters: int = 12, seed: int = 0,
               device: DeviceLike = None) -> np.ndarray:
    """Row order by projection onto the first principal component — an
    O(n*G) stand-in for dendrogram leaf order on very large panes (rows with
    similar CNV profiles still land next to each other).  x_cg is a host
    array (moved to `device`) or a tensor (on its own device when `device`
    is None)."""
    if torch.is_tensor(x_cg) and device is None:
        x = x_cg.to(torch.float32).clone()
    else:
        x = torch.as_tensor(np.array(x_cg, np.float32)).to(resolve_device(device))
    proj = _pc1_projection(x, iters, seed)
    if proj is None:
        return np.arange(x.shape[0])
    return torch.argsort(proj, stable=True).cpu().numpy()


def _group_cell_order(obj: InferCNV, group: str, idx: np.ndarray,
                      cluster: bool, order_cache: Optional[dict] = None,
                      hclust_method: str = "ward.D",
                      gene_sel: Optional[np.ndarray] = None,
                      ignore_subclusters: bool = False,
                      device: DeviceLike = None,
                      pc1_log: Optional[dict] = None):
    """Row ordering within one group plus the dendrogram that produced it
    (copied from :95-130): stored subcluster structure first (largest
    subcluster leading), each ordered by hclust leaf order (PC1 order above
    ORDER_LINKAGE_MAX cells); else fresh hclust with the requested linkage
    method.  gene_sel / ignore_subclusters implement the reference's
    ref_contig (inferCNV_heatmap.R:553-573).  order_cache: a dict shared
    across the pipeline's plots, keyed as the JAX package keys it.
    pc1_log: where given, each PC1-ordered block's rows and their
    projections are put under its group and first cell.  Returns (order_indices, linkage or
    None)."""
    if idx.size <= 2 or not cluster:
        return idx, None
    key = (group, hclust_method,
           None if gene_sel is None else gene_sel.tobytes())
    if order_cache is not None and key in order_cache:
        o, Z = order_cache[key]
        if o.size == idx.size:
            return o, Z
    o, Z = _group_cell_order_impl(obj, group, idx,
                                  R_TO_SCIPY_LINKAGE.get(hclust_method, "ward"),
                                  gene_sel, ignore_subclusters, device, pc1_log)
    if order_cache is not None:
        order_cache[key] = (o, Z)
    return o, Z


def _group_cell_order_impl(obj: InferCNV, group: str, idx: np.ndarray,
                           method: str = "ward",
                           gene_sel: Optional[np.ndarray] = None,
                           ignore_subclusters: bool = False,
                           device: DeviceLike = None,
                           pc1_log: Optional[dict] = None):
    """:133-176: the distances of a block through
    subcluster/distance.condensed_dists on `device` (host float64 up to
    1,024 rows, as there), the linkage in scipy, the PC1 order of a block of
    more than ORDER_LINKAGE_MAX rows from its rows gathered onto the
    device."""
    from scipy.cluster import hierarchy

    from infercnv_tpu_torch.subcluster.distance import condensed_dists
    from infercnv_tpu_torch.viz.dendro import merge_linkages

    dev = resolve_device(device)

    def rows(sel):
        x = obj.expr[sel]
        return x if gene_sel is None else x[:, gene_sel]

    def pc1(sel):
        proj = _pc1_projection(_Rows(np.asarray(obj.expr), dev).gather(sel, gene_sel))
        if proj is None:
            return sel
        if pc1_log is not None:
            pc1_log[(group, int(sel[0]))] = (sel, proj.cpu().numpy())
        return sel[torch.argsort(proj, stable=True).cpu().numpy()]

    subs = None
    if (not ignore_subclusters and obj.tumor_subclusters
            and group in obj.tumor_subclusters["subclusters"]):
        subs = obj.tumor_subclusters["subclusters"][group]
    if subs and len(subs) > 1:
        block_idx = []
        block_Z = []
        for _name, sidx in sorted(subs.items(), key=lambda kv: -len(kv[1])):
            sidx = np.asarray(sidx)
            if sidx.size > ORDER_LINKAGE_MAX:
                block_idx.append(pc1(sidx))
                block_Z.append(None)
            elif sidx.size > 2:
                Z = hierarchy.linkage(condensed_dists(rows(sidx), dev), method=method)
                block_idx.append(sidx[hierarchy.leaves_list(Z)])
                block_Z.append(Z)
            else:
                block_idx.append(sidx)
                block_Z.append(None)
        concat = np.concatenate(block_idx)
        Zm = merge_linkages(block_Z, [b.size for b in block_idx])
        if Zm is not None:
            # order the pane by the merged tree's own leaf traversal so the
            # drawn dendrogram lines up with the rows
            leaves = hierarchy.leaves_list(Zm)
            return concat[leaves], Zm
        return concat, None
    if idx.size > ORDER_LINKAGE_MAX:
        return pc1(idx), None
    Z = hierarchy.linkage(condensed_dists(rows(idx), dev), method=method)
    return idx[hierarchy.leaves_list(Z)], Z


# ---------------------------------------------------------------- panes ---

def _pane_edges(group_sizes: List[Tuple[str, int]], max_rows: int):
    """Display-bin edges per group (proportional bins within group
    boundaries, so separators stay exact; copied from :179-192).
    Returns (edges_per_group, new_sizes, downsampled?)."""
    n = sum(s for _g, s in group_sizes)
    if n <= max_rows:
        return None, group_sizes, False
    eds: List[np.ndarray] = []
    new_sizes: List[Tuple[str, int]] = []
    for g, size in group_sizes:
        nb = min(size, max(1, int(round(max_rows * size / n))))
        eds.append(np.linspace(0, size, nb + 1).astype(int))
        new_sizes.append((g, nb))
    return eds, new_sizes, True


@dataclasses.dataclass
class _Pane:
    """One pane's rows in display order and the display bin of each."""
    idx: np.ndarray           # source rows, in display order
    bins: np.ndarray          # display bin of each position
    counts: np.ndarray        # rows of each bin
    sizes: List[Tuple[str, int]]
    down: bool


def _pane(idx_ordered: np.ndarray, group_sizes: List[Tuple[str, int]],
          max_rows: int) -> _Pane:
    idx_ordered = np.asarray(idx_ordered, np.int64)
    edges, new_sizes, down = _pane_edges(group_sizes, max_rows)
    n = idx_ordered.size
    if not down:
        return _Pane(idx_ordered, np.arange(n), np.ones(n, np.int64), new_sizes, False)
    bins = np.empty(n, np.int64)
    counts = []
    acc = first = 0
    for (_g, size), ed in zip(group_sizes, edges):
        per = np.diff(ed)
        bins[acc:acc + size] = first + np.repeat(np.arange(per.size), per)
        counts.append(per)
        acc += size
        first += per.size
    return _Pane(idx_ordered, bins, np.concatenate(counts).astype(np.int64),
                 new_sizes, True)


def _bin_means(sums: torch.Tensor, counts: np.ndarray) -> np.ndarray:
    c = torch.from_numpy(counts.astype(np.float64)).to(sums.device)
    return (sums / c[:, None]).to(torch.float32).cpu().numpy()


def _dense_panes(rows: _Rows, panes: Sequence[_Pane], lo: float, hi: float,
                 lut: Optional[torch.Tensor] = None,
                 hist: Optional[_Histogram] = None) -> List[np.ndarray]:
    """Display matrices of dense panes in one pass over the source rows in
    order: each block's rows that a pane shows are clipped (after the lut)
    and added into their display bins in float64 (``index_add_``), then
    divided by the bins' row counts.  With `hist`, every block is also
    added to the key's histogram."""
    G = rows.src.shape[1]
    dev = rows.dev
    n_bins = [int(p.counts.size) for p in panes]
    first = np.concatenate([[0], np.cumsum(n_bins)])
    cells = np.concatenate([p.idx for p in panes] + [np.zeros(0, np.int64)])
    bins = np.concatenate([p.bins + f for p, f in zip(panes, first)]
                          + [np.zeros(0, np.int64)])
    order = np.argsort(cells, kind="stable")
    cells, bins = cells[order], bins[order]
    bins_t = torch.from_numpy(bins).to(dev)
    sums = torch.zeros((int(first[-1]), G), dtype=torch.float64, device=dev)
    lo32, hi32 = float(np.float32(lo)), float(np.float32(hi))
    for b, x in rows.chunks():
        a, e = np.searchsorted(cells, [b, b + x.shape[0]])
        if hist is not None:
            hist.add(x)
        if a == e:
            continue
        sel = torch.from_numpy(cells[a:e] - b).to(dev)
        v = x[sel]
        v = lut[v.to(torch.int64)] if lut is not None else v.to(torch.float32)
        sums.index_add_(0, bins_t[a:e], torch.clamp(v, lo32, hi32).to(torch.float64))
    return [_bin_means(sums[first[i]:first[i + 1]], p.counts)
            for i, p in enumerate(panes)]


def _factorized_panes(rows_kg: torch.Tensor, cell_to_row: np.ndarray,
                      panes: Sequence[_Pane], lo: float, hi: float) -> List[np.ndarray]:
    """Display matrices from factorized per-group values (rows [K, G] on the
    device + cell->row map): a bin's mean is the count-weighted sum of the
    few distinct group rows its cells map to (``index_add_`` over (bin, row)
    pairs), so the [C, G] matrix is never expanded."""
    lo32, hi32 = float(np.float32(lo)), float(np.float32(hi))
    rc = torch.clamp(rows_kg.to(torch.float32), lo32, hi32)
    K, G = rc.shape
    step = max(1, CHUNK_ELEMS // max(G, 1))
    out = []
    for p in panes:
        ids = cell_to_row[p.idx].astype(np.int64)
        if not p.down:
            out.append(rc[torch.from_numpy(ids).to(rc.device)].cpu().numpy())
            continue
        pair, cnt = np.unique(p.bins * K + ids, return_counts=True)
        sums = torch.zeros((p.counts.size, G), dtype=torch.float64, device=rc.device)
        for s in range(0, pair.size, step):
            pb = torch.from_numpy(pair[s:s + step] // K).to(rc.device)
            pr = torch.from_numpy(pair[s:s + step] % K).to(rc.device)
            w = torch.from_numpy(cnt[s:s + step].astype(np.float64)).to(rc.device)
            sums.index_add_(0, pb, rc[pr].to(torch.float64) * w[:, None])
        out.append(_bin_means(sums, p.counts))
    return out


def _pane_matrix_dense(expr, idx_ordered: np.ndarray,
                       group_sizes: List[Tuple[str, int]], max_rows: int,
                       lo: float, hi: float, lut: Optional[np.ndarray] = None,
                       device: DeviceLike = None):
    """Display matrix for one pane straight from the source rows
    (:195-226): each display bin is the mean of its member cells' clipped
    rows.  lut: optional value table for small-int sources (state
    matrices).  Returns (matrix, new_group_sizes, downsampled?)."""
    dev = resolve_device(device)
    p = _pane(idx_ordered, group_sizes, max_rows)
    lut_t = None if lut is None else torch.from_numpy(np.asarray(lut, np.float32)).to(dev)
    mat = _dense_panes(_Rows(np.asarray(expr), dev), [p], lo, hi, lut_t)[0]
    return mat, p.sizes, p.down


def _pane_matrix_rows(rows_kg: np.ndarray, cell_to_row: np.ndarray,
                      idx_ordered: np.ndarray,
                      group_sizes: List[Tuple[str, int]], max_rows: int,
                      lo: float, hi: float, device: DeviceLike = None):
    """Display matrix for one pane from factorized per-group values
    (:229-254).  Returns (matrix, new_group_sizes, downsampled?)."""
    dev = resolve_device(device)
    p = _pane(idx_ordered, group_sizes, max_rows)
    rk = torch.from_numpy(np.asarray(rows_kg, np.float32)).to(dev)
    mat = _factorized_panes(rk, np.asarray(cell_to_row), [p], lo, hi)[0]
    return mat, p.sizes, p.down


def _downsample_rows(mat: np.ndarray, group_sizes: List[Tuple[str, int]],
                     max_rows: int, device: DeviceLike = None):
    """Mean-aggregate consecutive rows (within group boundaries) down to
    <= max_rows display rows (:264-283), on `device`.  Returns (matrix,
    new_group_sizes, was_downsampled)."""
    p = _pane(np.arange(np.asarray(mat).shape[0]), group_sizes, max_rows)
    if not p.down:
        return mat, group_sizes, False
    x = torch.from_numpy(np.asarray(mat, np.float32)).to(resolve_device(device))
    sums = torch.zeros((p.counts.size, x.shape[1]), dtype=torch.float64, device=x.device)
    sums.index_add_(0, torch.from_numpy(p.bins).to(x.device), x.to(torch.float64))
    return _bin_means(sums, p.counts), p.sizes, True


def _bp_scale_matrix(data: np.ndarray, gene_order, chr_lengths=None,
                     width: int = 3000) -> Tuple[np.ndarray, List[int]]:
    """Resample gene columns onto a bp-proportional axis
    (reference plot_chr_scale, inferCNV_heatmap.R:352-397), host numpy on a
    display pane, copied from :286-325.  Returns the resampled matrix and
    per-chromosome boundary bin indices."""
    ranges = gene_order.chr_ranges()
    lens = []
    for ci, (b, e) in enumerate(ranges):
        if chr_lengths is not None and ci < len(chr_lengths):
            lens.append(int(chr_lengths[ci]))
        elif e > b:
            lens.append(int(gene_order.stop[b:e].max()))
        else:
            lens.append(1)
    total = float(sum(lens))
    bins = [max(2, int(round(width * l / total))) for l in lens]
    out_cols = []
    boundaries = [0]
    for ci, (b, e) in enumerate(ranges):
        nb = bins[ci]
        block = np.full((data.shape[0], nb), np.nan, np.float32)
        if e > b:
            mid = (gene_order.start[b:e] + gene_order.stop[b:e]) / 2.0
            pos = np.clip((mid / max(lens[ci], 1) * nb).astype(int), 0, nb - 1)
            for k in range(nb):
                sel = pos == k
                if sel.any():
                    block[:, k] = data[:, b:e][:, sel].mean(axis=1)
            # fill empty bins with nearest filled bin
            filled = ~np.isnan(block[0])
            if filled.any():
                idxs = np.arange(nb)
                nearest = idxs.copy()
                fi = idxs[filled]
                for k in idxs[~filled]:
                    nearest[k] = fi[np.argmin(np.abs(fi - k))]
                block = block[:, nearest]
        out_cols.append(block)
        boundaries.append(boundaries[-1] + nb)
    return np.concatenate(out_cols, axis=1), boundaries[:-1]


# ------------------------------------------------------------ data side ---

@dataclasses.dataclass
class HeatmapData:
    """What the render and the text outputs read, computed by heatmap_data."""
    x_center: float
    lo: float
    hi: float
    exact_stats: bool
    obs_idx: np.ndarray
    obs_group_sizes: List[Tuple[str, int]]
    obs_linkages: List
    ref_order: List[np.ndarray]
    ref_group_sizes: List[Tuple[str, int]]
    ref_linkages: List
    obs_mat: np.ndarray
    obs_sizes_d: List[Tuple[str, int]]
    obs_down: bool
    ref_mats: List[Tuple[np.ndarray, List[Tuple[str, int]]]]
    ref_downs: List[bool]
    hist_counts: np.ndarray
    hist_edges: np.ndarray
    #: (rows, projections) of each PC1-ordered block computed in this call,
    #: keyed by (group, first row of the block)
    pc1: Dict[Tuple[str, int], Tuple[np.ndarray, np.ndarray]]
    #: seconds of each part (host clock; the device's parts end in a copy
    #: to the host)
    seconds: Dict[str, float]

    @property
    def ref_idx(self) -> np.ndarray:
        return (np.concatenate(self.ref_order) if self.ref_order
                else np.zeros(0, np.int64))


def _ref_contig_genes(obj: InferCNV, ref_contig) -> Optional[np.ndarray]:
    """Genes of the named contig(s) (reference inferCNV_heatmap.R:553-573)."""
    if ref_contig is None:
        return None
    want = {ref_contig} if isinstance(ref_contig, str) else set(ref_contig)
    names = obj.gene_order.chr_names
    gene_sel = np.nonzero(np.isin(
        [names[c] for c in obj.gene_order.chr_ids], list(want)))[0]
    if gene_sel.size == 0:
        log_warn(f"ref_contig {ref_contig!r} matched no genes; "
                 "clustering by all genomic locations")
        return None
    return gene_sel


def heatmap_data(
    obj: InferCNV,
    k_obs_groups: int = 1,
    cluster_by_groups: bool = True,
    cluster_references: bool = True,
    x_center: Optional[float] = None,
    x_range="auto",
    max_pane_rows: int = 2000,
    row_order_cache: Optional[dict] = None,
    row_values: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    value_lut: Optional[np.ndarray] = None,
    hclust_method: str = "ward.D",
    ref_contig=None,
    device: DeviceLike = None,
) -> HeatmapData:
    """The data side of plot_cnv (the JAX package's :382-535 and :674-684)
    on `device`; arguments as plot_cnv's."""
    from scipy.cluster import hierarchy

    from infercnv_tpu_torch.subcluster.distance import condensed_dists

    dev = resolve_device(device)
    secs: Dict[str, float] = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        secs[name] = secs.get(name, 0.0) + now - clock[0]
        clock[0] = now

    expr = obj.expr
    C = expr.shape[0]
    rows_kg = cell_to_row = None
    src = np.asarray(expr)
    if row_values is not None:
        rows_kg = torch.from_numpy(np.asarray(row_values[0], np.float32)).to(dev)
        cell_to_row = np.asarray(row_values[1], np.int64)
    lut = None if value_lut is None else \
        torch.from_numpy(np.asarray(value_lut, np.float32)).to(dev)
    rows = _Rows(src, dev)

    exact_stats = rows_kg is None and lut is None and \
        expr.shape[0] * expr.shape[1] <= EXACT_STATS_MAX_ELEMS

    def all_blocks():
        return (x for _b, x in rows.chunks())

    sample = None

    def value_sample() -> torch.Tensor:
        """Representative float values for center/range/histogram when the
        exact full-matrix statistics would be too expensive (:394-401)."""
        nonlocal sample
        if rows_kg is not None:
            return rows_kg
        if sample is None:
            step = max(1, C // 4096)
            raw = torch.from_numpy(np.ascontiguousarray(src[::step])).to(dev)
            sample = lut[raw.to(torch.int64)] if lut is not None else raw.to(torch.float32)
        return sample

    if x_center is None:
        if rows_kg is not None:
            w = torch.bincount(torch.from_numpy(cell_to_row).to(dev),
                               minlength=rows_kg.shape[0]).to(torch.float64)
            x_center = float((w @ rows_kg.to(torch.float64).mean(dim=1)) / w.sum())
        elif lut is not None:
            cnt = 0
            for x in all_blocks():
                cnt = cnt + torch.bincount(x.reshape(-1).to(torch.int64),
                                           minlength=lut.numel())
            cnt = cnt.cpu().numpy()
            lut_h = np.asarray(value_lut, np.float32)
            x_center = float(np.nansum(cnt * np.nan_to_num(lut_h)) / cnt.sum())
        else:
            x_center = _mean(rows)
        lap("center")
    if isinstance(x_range, str) and x_range == "auto" or x_range is None:
        if exact_stats:
            lo, hi = _x_range(all_blocks, x_center)
        else:
            vs = value_sample()
            lo, hi = _x_range(lambda: [vs], x_center)
            log_info("-x_range: estimated from sampled/factorized rows")
        lap("range")
    else:
        lo, hi = float(x_range[0]), float(x_range[1])

    # ordering.  ref_contig: cluster rows on the named contig's genes only,
    # ignoring stored subclusters.
    gene_sel = _ref_contig_genes(obj, ref_contig)
    pc1: Dict[Tuple[str, int], Tuple[np.ndarray, np.ndarray]] = {}

    def order_group(group, idx, cluster):
        return _group_cell_order(obj, group, idx, cluster, row_order_cache,
                                 hclust_method=hclust_method,
                                 gene_sel=gene_sel,
                                 ignore_subclusters=gene_sel is not None,
                                 device=dev, pc1_log=pc1)

    obs_order: List[np.ndarray] = []
    obs_group_sizes: List[Tuple[str, int]] = []
    obs_linkages: List = []
    if cluster_by_groups:
        for g, idx in obj.obs_groups.items():
            o, Z = order_group(g, np.asarray(idx), True)
            obs_order.append(o)
            obs_group_sizes.append((g, o.size))
            obs_linkages.append(Z)
    else:
        idx = obj.all_obs_idx()
        if (k_obs_groups > 1 and k_obs_groups < idx.size
                and idx.size <= ORDER_LINKAGE_MAX):
            # cut the SAME linkage that orders the rows into k blocks,
            # cached like any other ordering; block sizes follow leaf order
            kkey = ("all_observations@k", hclust_method,
                    None if gene_sel is None else gene_sel.tobytes(),
                    k_obs_groups)
            cached = (row_order_cache or {}).get(kkey)
            if cached is not None and cached[0].size == idx.size:
                o, (Zo, obs_group_sizes) = cached
            else:
                rows_for_split = obj.expr[idx]
                if gene_sel is not None:  # ref_contig drives this split too
                    rows_for_split = rows_for_split[:, gene_sel]
                Zo = hierarchy.linkage(
                    condensed_dists(rows_for_split, dev),
                    method=R_TO_SCIPY_LINKAGE.get(hclust_method, "ward"))
                grps = hierarchy.fcluster(Zo, t=k_obs_groups,
                                          criterion="maxclust")
                leaf = hierarchy.leaves_list(Zo)
                o = idx[leaf]
                labs = grps[leaf]
                change = np.nonzero(np.diff(labs))[0] + 1
                bounds = np.concatenate([[0], change, [labs.size]])
                obs_group_sizes = [
                    (f"obs_grp_{labs[b]}", int(e - b))
                    for b, e in zip(bounds[:-1], bounds[1:])]
                if row_order_cache is not None:
                    row_order_cache[kkey] = (o, (Zo, obs_group_sizes))
            obs_linkages.append(Zo)
        else:
            o, Zo = order_group("all_observations", idx, True)
            obs_linkages.append(Zo)
            if k_obs_groups > 1 and k_obs_groups < idx.size:
                log_warn(f"k_obs_groups={k_obs_groups} needs a full linkage "
                         f"but the pane has {idx.size} cells (> "
                         f"{ORDER_LINKAGE_MAX}); keeping one group")
            obs_group_sizes = [("all_observations", o.size)]
        obs_order = [o]
    obs_idx = np.concatenate(obs_order) if obs_order else np.zeros(0, np.int64)

    ref_order: List[np.ndarray] = []
    ref_group_sizes: List[Tuple[str, int]] = []
    ref_linkages: List = []
    for g, idx in obj.ref_groups.items():
        o, Zr = order_group(g, np.asarray(idx), cluster_references)
        ref_order.append(o)
        ref_group_sizes.append((g, o.size))
        ref_linkages.append(Zr)
    lap("order")

    # display panes straight from the source (downsample-first); the
    # histogram rides on the same pass over the rows when it is exact
    panes = [_pane(obs_idx, obs_group_sizes, max_pane_rows)]
    panes += [_pane(o, [(g, size)], max(64, max_pane_rows // 4))
              for o, (g, size) in zip(ref_order, ref_group_sizes)]
    hist = _Histogram(lo, hi)
    if rows_kg is not None:
        mats = _factorized_panes(rows_kg, cell_to_row, panes, lo, hi)
    else:
        mats = _dense_panes(rows, panes, lo, hi, lut,
                            hist=hist if exact_stats else None)
    lap("panes")
    if not exact_stats:
        w = None
        if rows_kg is not None:
            # factorized panes: weight each group row by its cell count, so
            # the density curve reflects the plotted [C, G] distribution
            w = torch.bincount(torch.from_numpy(cell_to_row).to(dev),
                               minlength=rows_kg.shape[0]).to(torch.float64)
            w = w[:, None].expand(rows_kg.shape)
        hist.add(value_sample(), w)
    hist_counts, hist_edges = hist.result()
    del hist, sample
    lap("histogram")

    return HeatmapData(
        x_center=x_center, lo=lo, hi=hi, exact_stats=exact_stats,
        obs_idx=obs_idx, obs_group_sizes=obs_group_sizes,
        obs_linkages=obs_linkages, ref_order=ref_order,
        ref_group_sizes=ref_group_sizes, ref_linkages=ref_linkages,
        obs_mat=mats[0], obs_sizes_d=panes[0].sizes, obs_down=panes[0].down,
        ref_mats=[(m, p.sizes) for m, p in zip(mats[1:], panes[1:])],
        ref_downs=[p.down for p in panes[1:]],
        hist_counts=hist_counts, hist_edges=hist_edges, pc1=pc1, seconds=secs)


# -------------------------------------------------------------- render ---

def _render(obj: InferCNV, d: HeatmapData, out_path: str, title: str,
            custom_color_pal, png_res: int, plot_chr_scale: bool, chr_lengths,
            color_safe_pal: bool, contig_lab_size: int, obs_title: str,
            ref_title: str, dynamic_resize: float) -> None:
    """The matplotlib figure (copied from :526-698)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import ListedColormap, Normalize

    from infercnv_tpu_torch.viz.dendro import draw_linkage

    lo, hi, x_center = d.lo, d.hi, d.x_center
    obs_mat, ref_mats = d.obs_mat, d.ref_mats
    # display-space transform (bp-proportional x axis if requested) — on
    # the downsampled panes, never the full matrix
    disp_bounds = None
    if plot_chr_scale:
        obs_mat, disp_bounds = _bp_scale_matrix(obs_mat, obj.gene_order,
                                                chr_lengths)
        ref_mats = [(_bp_scale_matrix(m, obj.gene_order, chr_lengths)[0], sz)
                    for m, sz in ref_mats]
    W = obs_mat.shape[1] if obs_mat.size else (
        ref_mats[0][0].shape[1] if ref_mats else obj.expr.shape[1])

    n_obs, n_ref = d.obs_idx.size, d.ref_idx.size
    have_ref = n_ref > 0
    fig_h = 8.0
    if dynamic_resize and dynamic_resize > 0 and n_obs > 200:
        fig_h += dynamic_resize * 3.6 * (n_obs - 200) / 200.0
        fig_h = min(fig_h, 32767 / max(png_res, 1))  # cairo-style pixel cap
    ref_frac = min(0.35, max(0.12, n_ref / max(n_obs + n_ref, 1))) if have_ref else 0.0
    nrows = 3 if have_ref else 2
    fig = plt.figure(figsize=(11.6, fig_h))
    gs = fig.add_gridspec(
        nrows, 2,
        height_ratios=([0.035, 1 - ref_frac, ref_frac] if have_ref else [0.035, 1.0]),
        width_ratios=[0.05, 0.95], hspace=0.06, wspace=0.01,
        left=0.07, right=0.93)
    ax_chr = fig.add_subplot(gs[0, 1])
    ax_obs = fig.add_subplot(gs[1, 1])
    ax_obs_dend = fig.add_subplot(gs[1, 0])
    # each reference group gets its OWN pane with its own dendrogram
    # (reference .plot_cnv_references, inferCNV_heatmap.R:985+), heights
    # proportional to group size
    ref_axes: List = []
    ref_dend_axes: List = []
    if have_ref:
        hr = [max(int(s), 1) for (_g, s) in d.ref_group_sizes]
        sub = gs[2, 1].subgridspec(len(d.ref_order), 1, hspace=0.08,
                                   height_ratios=hr)
        subd = gs[2, 0].subgridspec(len(d.ref_order), 1, hspace=0.08,
                                    height_ratios=hr)
        ref_axes = [fig.add_subplot(sub[i]) for i in range(len(d.ref_order))]
        ref_dend_axes = [fig.add_subplot(subd[i]) for i in range(len(d.ref_order))]
    fig.add_subplot(gs[0, 0]).axis("off")

    # chromosome bar
    if plot_chr_scale:
        spans = disp_bounds + [W]
        bar = np.concatenate([
            np.full(spans[ci + 1] - spans[ci], ci % len(CHR_BAR_COLORS))
            for ci in range(len(disp_bounds))
        ])[None, :]
        label_pos = [(spans[ci] + spans[ci + 1]) / 2 for ci in range(len(disp_bounds))]
        boundaries = list(disp_bounds)
        chr_labels = list(obj.gene_order.chr_names)[: len(disp_bounds)]
    else:
        chr_ids = obj.gene_order.chr_ids
        bar = np.array([int(c) % len(CHR_BAR_COLORS) for c in chr_ids])[None, :]
        boundaries = []
        label_pos = []
        chr_labels = []
        for ci, (b, e) in enumerate(obj.gene_order.chr_ranges()):
            if e > b:
                boundaries.append(b)
                label_pos.append((b + e) / 2)
                chr_labels.append(obj.gene_order.chr_names[ci])
    ax_chr.imshow(bar, aspect="auto", cmap=ListedColormap(CHR_BAR_COLORS),
                  vmin=0, vmax=len(CHR_BAR_COLORS) - 1, interpolation="nearest")
    ax_chr.set_yticks([])
    ax_chr.set_xticks([])
    for pos, lab in zip(label_pos, chr_labels):
        ax_chr.text(pos, -0.8, lab, ha="center", va="bottom",
                    fontsize=contig_lab_size)
    ax_chr.set_title(title, fontsize=11, pad=16)

    if custom_color_pal is not None and not hasattr(custom_color_pal, "N"):
        # a sequence of colors (reference custom_pal = color.palette(...)):
        # build the ramp from them
        from matplotlib.colors import LinearSegmentedColormap

        custom_color_pal = LinearSegmentedColormap.from_list(
            "infercnv_custom", list(custom_color_pal), N=255)
    cmap = custom_color_pal or color_palette(color_safe_pal)
    norm = Normalize(vmin=lo, vmax=hi)

    def pane(ax, mat, group_sizes, label):
        if mat.shape[0] == 0:
            ax.axis("off")
            return
        ax.imshow(mat[::-1], aspect="auto", cmap=cmap, norm=norm,
                  interpolation="nearest")
        for b in boundaries[1:]:
            ax.axvline(b - 0.5, color="black", lw=0.4)
        acc = 0
        n = mat.shape[0]
        for (_g, size) in group_sizes[:-1]:
            acc += size
            ax.axhline(n - acc - 0.5, color="black", lw=0.6)
        ax.set_yticks([])
        ax.set_xticks([])
        if label:
            ax.set_ylabel(label, fontsize=8)
            ax.yaxis.set_label_coords(-0.075, 0.5)
        # group labels on the right
        acc = 0
        for (g, size) in group_sizes:
            ax.text(W + W * 0.005, n - (acc + size / 2), str(g)[:30],
                    fontsize=5, va="center", ha="left", clip_on=False)
            acc += size

    pane(ax_obs, obs_mat, d.obs_sizes_d, obs_title)
    if have_ref:
        for i, (m, sz_d) in enumerate(ref_mats):
            pane(ref_axes[i], m, sz_d,
                 ref_title if i == (len(ref_mats) - 1) // 2 else "")

    def dendro_panel(ax, linkages, group_sizes, n_rows):
        ax.axis("off")
        if n_rows == 0:
            return
        acc = 0
        for Z, (_g, size) in zip(linkages, group_sizes):
            if Z is not None and size > 2:
                draw_linkage(ax, Z, n_rows, acc, size)
            acc += size
        ax.set_xlim(0, 1)
        ax.set_ylim(0, n_rows)

    # downsampled panes have no 1:1 row mapping for the tree leaves
    dendro_panel(ax_obs_dend, d.obs_linkages if not d.obs_down else [],
                 d.obs_group_sizes if not d.obs_down else [], n_obs)
    if have_ref:
        for i, (Zr, (g, size)) in enumerate(zip(d.ref_linkages, d.ref_group_sizes)):
            dendro_panel(ref_dend_axes[i],
                         [Zr] if not d.ref_downs[i] else [],
                         [(g, size)] if not d.ref_downs[i] else [], size)

    # color key with value-density histogram (the vendored heatmap.cnv key,
    # reference inferCNV_heatmap.R:1461-1474, density.info='histogram')
    kax = fig.add_axes([0.015, 0.82, 0.09, 0.1])
    grad = np.linspace(lo, hi, 256)[None, :]
    kax.imshow(grad, aspect="auto", cmap=cmap, norm=norm,
               extent=(lo, hi, 0.0, 1.0))
    counts, edges = d.hist_counts, d.hist_edges
    if counts.max() > 0:
        dens = counts / counts.max()
        kax.plot((edges[:-1] + edges[1:]) / 2, dens, color="cyan", lw=0.7)
    kax.set_yticks([])
    kax.set_xticks([lo, x_center, hi])
    kax.set_xticklabels([f"{lo:.2f}", f"{x_center:.2f}", f"{hi:.2f}"])
    kax.tick_params(labelsize=5)
    kax.set_title("Distribution of Expression", fontsize=5)

    fig.savefig(out_path, dpi=png_res, bbox_inches="tight")
    plt.close(fig)


def _write_text_outputs(obj: InferCNV, d: HeatmapData, out_dir: str,
                        output_filename: str, write_expr: bool, write_phylo: bool,
                        hclust_method: str, row_values, value_lut,
                        dev: torch.device) -> None:
    """The newick, groupings, thresholds and expression text outputs
    (copied from :700-751; reference :803-846)."""
    lo, hi = d.lo, d.hi
    if write_phylo:
        from scipy.cluster import hierarchy

        from infercnv_tpu_torch.report.newick import merged_group_newick
        from infercnv_tpu_torch.subcluster.distance import condensed_dists

        method = R_TO_SCIPY_LINKAGE.get(hclust_method, "ward")
        linkages, labels = {}, {}
        for g, idx in obj.obs_groups.items():
            idx = np.asarray(idx)
            if idx.size > ORDER_LINKAGE_MAX:
                # a per-cell newick needs an O(n^2) condensed matrix
                log_warn(f"write_phylo: skipping group {g!r} "
                         f"({idx.size} cells > {ORDER_LINKAGE_MAX})")
                continue
            labels[g] = [obj.cell_names[i] for i in idx]
            linkages[g] = (hierarchy.linkage(condensed_dists(obj.expr[idx], dev),
                                             method=method)
                           if idx.size > 2 else None)
        nwk = merged_group_newick(linkages, labels)
        with open(os.path.join(out_dir, f"{output_filename}.observations_dendrogram.txt"), "w") as f:
            f.write(nwk + "\n")

    with open(os.path.join(out_dir, f"{output_filename}.observation_groupings.txt"), "w") as f:
        f.write("cell_group_name cell\n")
        # walk obs_idx by the group sizes (the k_obs_groups split holds one
        # concatenated order for k groups)
        pos = 0
        for (g, size) in d.obs_group_sizes:
            for r in d.obs_idx[pos:pos + size]:
                f.write(f"{g} {obj.cell_names[r]}\n")
            pos += size
    with open(os.path.join(out_dir, f"{output_filename}.heatmap_thresholds.txt"), "w") as f:
        for v in np.linspace(lo, hi, 31):
            f.write(f"{v}\n")
    if write_expr:
        # the one output that inherently needs the full clipped matrix —
        # materialized only on request, on the host as in the JAX package
        expr = np.asarray(obj.expr)
        if row_values is not None:
            data = np.clip(np.asarray(row_values[0], np.float32), lo, hi)[
                np.asarray(row_values[1], np.int64)]
        elif value_lut is not None:
            data = np.clip(np.asarray(value_lut, np.float32)[expr], lo, hi)
        else:
            data = np.clip(expr.astype(np.float32, copy=False), lo, hi)
        write_expr_matrix(os.path.join(out_dir, f"{output_filename}.observations.txt"),
                          data, obj.gene_order, obj.cell_names, d.obs_idx)
        if d.ref_idx.size:
            write_expr_matrix(os.path.join(out_dir, f"{output_filename}.references.txt"),
                              data, obj.gene_order, obj.cell_names, d.ref_idx)


def plot_cnv(
    obj: InferCNV,
    out_dir: str,
    output_filename: str = "infercnv",
    title: str = "inferCNV",
    k_obs_groups: int = 1,
    cluster_by_groups: bool = True,
    cluster_references: bool = True,
    x_center: Optional[float] = None,
    x_range="auto",
    custom_color_pal=None,
    output_format: str = "png",
    png_res: int = 150,
    write_expr: bool = False,
    write_phylo: bool = False,
    plot_chr_scale: bool = False,
    chr_lengths=None,
    color_safe_pal: bool = False,
    contig_lab_size: int = 6,
    obs_title: str = "Observations (Cells)",
    ref_title: str = "References (Cells)",
    dynamic_resize: float = 0.0,
    max_pane_rows: int = 2000,
    row_order_cache: Optional[dict] = None,
    row_values: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    value_lut: Optional[np.ndarray] = None,
    hclust_method: str = "ward.D",
    ref_contig=None,
    device: DeviceLike = None,
    timings: Optional[dict] = None,
) -> Optional[str]:
    """Render the heatmap; returns the output image path.

    dynamic_resize (reference inferCNV_heatmap.R:254-262): with > 200
    observation cells, the figure height grows by
    ``dynamic_resize * 3.6 * (nobs - 200) / 200`` inches.

    Two factorized inputs avoid the read pass over [C, G]:

    * ``row_values=(rows [K, G], cell_to_row [C])`` — per-group values
      (HMM state calls); panes render in O(K*G).  ``obj.expr`` is then only
      consulted for row ordering (usually a row_order_cache hit).
    * ``value_lut`` — obj.expr holds small ints (a state matrix); display
      values are ``value_lut[state]``, applied per block.

    The data side runs on `device` (CUDA unless "cpu"); `timings`, when
    given, receives the seconds of the data side ("data") and of the text
    outputs and the figure ("render").
    """
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    d = heatmap_data(obj, k_obs_groups=k_obs_groups,
                     cluster_by_groups=cluster_by_groups,
                     cluster_references=cluster_references, x_center=x_center,
                     x_range=x_range, max_pane_rows=max_pane_rows,
                     row_order_cache=row_order_cache, row_values=row_values,
                     value_lut=value_lut, hclust_method=hclust_method,
                     ref_contig=ref_contig, device=dev)
    t1 = time.perf_counter()
    if timings is not None:
        timings["data"] = timings.get("data", 0.0) + t1 - t0
    try:
        _write_text_outputs(obj, d, out_dir, output_filename, write_expr,
                            write_phylo, hclust_method, row_values, value_lut, dev)
        ext = output_format if output_format in ("png", "pdf", "svg") else "png"
        out_path = os.path.join(out_dir, f"{output_filename}.{ext}")
        _render(obj, d, out_path, title, custom_color_pal, png_res,
                plot_chr_scale, chr_lengths, color_safe_pal, contig_lab_size,
                obs_title, ref_title, dynamic_resize)
    finally:
        if timings is not None:
            timings["render"] = timings.get("render", 0.0) + time.perf_counter() - t1
    log_info(f"-wrote heatmap: {out_path}")
    return out_path
