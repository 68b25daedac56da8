"""Bin-packed batched Viterbi over chromosomes.

Counterpart of infercnv_tpu/ops/viterbi_pack.py (lines 38-227).  The
packing (``pack_indices``, ``PackedLayout``, ``get_layout``) is plain numpy,
copied from there; ``force_short_neutral`` and ``viterbi_packed`` are the
PyTorch versions.

reference semantics: Viterbi.dthmm.adj (R/inferCNV_HMM.R:1101-1176) run per
(row x chromosome); state sds collapse to their median (:1122); sequences of
length < 2 get the neutral state (:1104-1107).

Chromosomes are first-fit-decreasing bin-packed into bins of capacity
Lmax = longest chromosome, with the chain restarting at each chromosome
start inside a bin, so the sequential scan runs over ~sum(chr lengths)
rather than n_chr * max(chr length).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from infercnv_tpu_torch.core.genome import GeneOrder
from infercnv_tpu_torch.ops.viterbi_kernel import transition_logs, viterbi
from infercnv_tpu_torch.utils import profiling


def pack_indices(gene_order: GeneOrder) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray, int]:
    """First-fit-decreasing bin-packing of chromosomes into padded bins.

    Returns (gather_idx [n_bins, Lmax], valid [n_bins, Lmax],
    boundaries [n_bins, Lmax], Lmax)."""
    ranges = [r for r in gene_order.chr_ranges() if r[1] > r[0]]
    Lmax = max(e - b for (b, e) in ranges)
    order = sorted(range(len(ranges)),
                   key=lambda i: ranges[i][1] - ranges[i][0], reverse=True)
    bins: list = []       # list of (used, [range, ...])
    for i in order:
        n = ranges[i][1] - ranges[i][0]
        for bi, (used, members) in enumerate(bins):
            if used + n <= Lmax:
                bins[bi] = (used + n, members + [ranges[i]])
                break
        else:
            bins.append((n, [ranges[i]]))
    n_bins = len(bins)
    gather = np.zeros((n_bins, Lmax), np.int32)
    valid = np.zeros((n_bins, Lmax), bool)
    boundaries = np.zeros((n_bins, Lmax), np.int8)
    for bi, (_used, members) in enumerate(bins):
        pos = 0
        for (b, e) in members:
            n = e - b
            gather[bi, pos:pos + n] = np.arange(b, e)
            valid[bi, pos:pos + n] = True
            boundaries[bi, pos] = 1
            pos += n
    return gather, valid, boundaries, Lmax


@dataclasses.dataclass
class PackedLayout:
    """Packing of one genome plus the inverse map for unpacking."""

    gather: np.ndarray       # [n_bins, Lmax] int32 gene gather indices
    valid: np.ndarray        # [n_bins, Lmax] bool
    boundaries: np.ndarray   # [n_bins, Lmax] int8 chromosome starts
    Lmax: int
    inv_pack: np.ndarray     # [G] flat position of gene g in the packed layout
    short_genes: Optional[np.ndarray]  # genes on < 2-gene chromosomes
    num_genes: int

    @staticmethod
    def from_gene_order(gene_order: GeneOrder) -> "PackedLayout":
        gather, valid, boundaries, Lmax = pack_indices(gene_order)
        inv = np.zeros(gene_order.num_genes, np.int32)
        flat = gather.reshape(-1)
        fvalid = valid.reshape(-1)
        inv[flat[fvalid]] = np.nonzero(fvalid)[0]
        short = [np.arange(b, e) for (b, e) in gene_order.chr_ranges()
                 if 0 < e - b < 2]
        short_genes = (np.concatenate(short).astype(np.int32)
                       if short else None)
        return PackedLayout(gather=gather, valid=valid, boundaries=boundaries,
                            Lmax=Lmax, inv_pack=inv, short_genes=short_genes,
                            num_genes=gene_order.num_genes)


# genome-content -> layout memo, keyed on content (never id(): a collected
# GeneOrder's address can be reused by a different genome)
_LAYOUT_MEMO: dict = {}


def layout_key(gene_order: GeneOrder) -> tuple:
    """Hashable content fingerprint of the chromosome structure."""
    return (gene_order.num_genes, tuple(gene_order.chr_names),
            gene_order.chr_ids.tobytes())


def get_layout(gene_order: GeneOrder) -> PackedLayout:
    key = layout_key(gene_order)
    hit = _LAYOUT_MEMO.get(key)
    if hit is None:
        hit = PackedLayout.from_gene_order(gene_order)
        if len(_LAYOUT_MEMO) > 64:
            _LAYOUT_MEMO.clear()
        _LAYOUT_MEMO[key] = hit
    return hit


def force_short_neutral(states: torch.Tensor, short_genes, S: int) -> torch.Tensor:
    """Chromosomes with < 2 genes get the neutral state
    (R/inferCNV_HMM.R:1104-1107).  Writes into ``states``."""
    if short_genes is None:
        return states
    profiling.host_upload(short_genes, states.device)
    idx = torch.as_tensor(short_genes, dtype=torch.int64, device=states.device)
    states[:, idx] = (S - 1) // 2 + 1
    return states


def viterbi_packed(resid: torch.Tensor, layout: PackedLayout, means,
                   sigma_rows: torch.Tensor, hmm_t: float) -> torch.Tensor:
    """Per-row Viterbi over bin-packed chromosomes.

    resid: [C, G] f32; sigma_rows: [C] per-row emission sigma; means: [S]
    state means.  Returns 1-based int8 states [C, G].  On a CUDA device the
    recursion is the CUDA kernel (ops/viterbi_kernel.py).  Spans
    ``icnv.viterbi`` with ``.pack``, ``.kernel`` and ``.unpack``; each
    layout upload is a blocking copy (``host_syncs``)."""
    dev = resid.device
    with profiling.span("icnv.viterbi", dev):
        means = np.asarray(means, np.float32)
        S = means.shape[0]
        C = resid.shape[0]
        Lmax = layout.Lmax
        with profiling.span("icnv.viterbi.pack", dev):
            # three layout uploads from numpy, and sigma's unless on the card
            profiling.host_sync(dev, 3)
            profiling.host_upload(sigma_rows, dev)
            gather = torch.as_tensor(layout.gather, dtype=torch.int64, device=dev)
            n_bins = gather.shape[0]
            B = C * n_bins
            xp = resid[:, gather].reshape(B, Lmax)             # [C * n_bins, Lmax]
            lengths = torch.as_tensor(layout.valid.sum(axis=1), dtype=torch.int32,
                                      device=dev).repeat(C)
            bnd = torch.as_tensor(layout.boundaries, device=dev).repeat(C, 1)
            sigma_b = torch.as_tensor(sigma_rows, dtype=torch.float32,
                                      device=dev).repeat_interleave(n_bins)
            log_diag, log_off, log_delta = transition_logs(S, hmm_t)
        with profiling.span("icnv.viterbi.kernel", dev):
            states = viterbi(xp, lengths, sigma_b, bnd, means, log_delta,
                             log_diag, log_off)
        with profiling.span("icnv.viterbi.unpack", dev):
            profiling.host_sync(dev)
            inv = torch.as_tensor(layout.inv_pack, dtype=torch.int64, device=dev)
            if states.stride() == (1, states.shape[0]) and Lmax > 1:
                # the kernel's [Lmax, C * n_bins] states, seen transposed:
                # each gene's state is read from its bin and position in one
                # gather, giving [G, C], returned as a [C, G] view
                lb = states.t().view(Lmax, C, n_bins)
                vals = lb[inv % Lmax, :, inv // Lmax].t()
            else:
                vals = states.reshape(C, n_bins * Lmax)[:, inv]
            return force_short_neutral(vals, layout.short_genes, S)
