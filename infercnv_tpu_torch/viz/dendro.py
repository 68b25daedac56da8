"""Dendrogram construction & drawing for heatmap side panels.

The reference stitches per-subcluster trees into one phylo object with
root-edge arithmetic (inferCNV_tumor_subclusters.R:602-641) and draws it
beside the observation pane (vendored heatmap engine).  Here the analogue:
scipy linkages per subcluster merged into one linkage whose leaf order is
their concatenation, drawn as line segments aligned to the heatmap rows.

Copied from infercnv_tpu/viz/dendro.py (all of it: ``merge_linkages`` :18,
``draw_linkage`` :74), host numpy and scipy.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy.cluster import hierarchy


def merge_linkages(linkages: Sequence[Optional[np.ndarray]],
                   leaf_counts: Sequence[int]) -> Optional[np.ndarray]:
    """Merge per-block linkages (leaf order preserved per block, blocks
    concatenated) into one linkage by joining block roots at increasing
    heights above the tallest block."""
    total = sum(leaf_counts)
    if total < 2:
        return None
    merged_rows: List[List[float]] = []
    offsets = np.cumsum([0] + list(leaf_counts))
    # node ids: leaves 0..total-1; internal nodes total + row_index
    next_node = total
    roots: List[Tuple[int, int, float]] = []  # (node_id, size, height)
    max_h = 0.0
    for bi, (Z, n) in enumerate(zip(linkages, leaf_counts)):
        off = offsets[bi]
        if n == 1:
            roots.append((off, 1, 0.0))
            continue
        if Z is None:
            # chain the leaves at zero-ish heights
            node = off
            size = 1
            h = 0.0
            for leaf in range(off + 1, off + n):
                merged_rows.append([node, leaf, h, size + 1])
                node = next_node
                next_node += 1
                size += 1
            roots.append((node, n, h))
            continue
        local_map: dict = {}
        for ri, (a, b, h, size) in enumerate(np.asarray(Z).tolist()):
            # ids < n are leaves (offset into the merged numbering); ids >= n
            # refer to local internal rows, renumbered via local_map
            na = off + int(a) if int(a) < n else local_map[int(a)]
            nb = off + int(b) if int(b) < n else local_map[int(b)]
            merged_rows.append([na, nb, float(h), int(size)])
            local_map[n + ri] = next_node
            next_node += 1
            max_h = max(max_h, float(h))
        roots.append((local_map[n + len(Z) - 1], n, float(np.asarray(Z)[-1, 2])))
    # join block roots left-to-right at increasing heights
    if len(roots) > 1:
        join_h = max_h if max_h > 0 else 1.0
        node, size, _ = roots[0]
        for (rnode, rsize, _h) in roots[1:]:
            join_h *= 1.08
            merged_rows.append([node, rnode, join_h, size + rsize])
            node = next_node
            next_node += 1
            size += rsize
    Zm = np.asarray(merged_rows, np.float64)
    return Zm if Zm.shape[0] == total - 1 else None


def draw_linkage(ax, Z: np.ndarray, n_rows_total: int, row_start: int,
                 n_leaves: int, color: str = "black", lw: float = 0.5) -> None:
    """Draw `Z` sideways (root left, leaves right) onto `ax`, a NORMAL
    (y-up) axis spanning [0, n_rows_total].

    Row geometry: the heatmap pane renders mat[::-1] on an image axis, so
    pane display row r (0-based, in pane order) sits at PHYSICAL height
    r + 0.5 from the bottom — which in this y-up axis is simply
    y = row_start + r + 0.5.  (The previous n - r - 0.5 formula mirrored
    every tree vertically against its rows.)"""
    dd = hierarchy.dendrogram(Z, no_plot=True, color_threshold=-1)
    leaves = dd["leaves"]
    # leaf order from dendrogram maps leaf position p -> original leaf index;
    # we want original leaf index i at display position its row order — the
    # pane was ordered by this same linkage's leaf order, so position p is
    # display row p.
    max_h = max(max(d) for d in dd["dcoord"]) or 1.0
    for xs, ys in zip(dd["icoord"], dd["dcoord"]):
        # icoord: leaf-axis coords (5, 15, ...) -> display rows
        rows = [(x - 5.0) / 10.0 for x in xs]
        ypts = [row_start + r + 0.5 for r in rows]
        xpts = [1.0 - (h / max_h) for h in ys]  # root at x=0, leaves x=1
        ax.plot(xpts, ypts, color=color, lw=lw)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, n_rows_total)
    ax.axis("off")
