"""Newick tree export for dendrograms (write_phylo outputs).

The reference manipulates ape 'phylo' objects and writes newick
(R/inferCNV_heatmap.R:820-830, infercnv_sampling.R tree rewrites).  Here we
serialize scipy linkage matrices directly.

Copied from infercnv_tpu/report/newick.py (all of it: ``linkage_to_newick``
:25, ``merged_group_newick`` :49), host code.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _sanitize(label: str) -> str:
    """Newick-reserved characters in leaf labels -> '_' (space, comma,
    colon, parentheses, semicolon, quotes) — one rule for every writer."""
    out = label
    for ch in ' ,:();\'"':
        out = out.replace(ch, "_")
    return out


def linkage_to_newick(Z: np.ndarray, labels: Sequence[str]) -> str:
    """Convert a scipy linkage matrix to a newick string with branch lengths
    derived from merge heights (leaf at height 0)."""
    Z = np.asarray(Z)
    n = Z.shape[0] + 1
    heights = {i: 0.0 for i in range(n)}
    children = {}
    for k in range(Z.shape[0]):
        a, b, h = int(Z[k, 0]), int(Z[k, 1]), float(Z[k, 2])
        node = n + k
        children[node] = (a, b)
        heights[node] = h

    def rec(node) -> str:
        if node < n:
            return _sanitize(labels[node])
        a, b = children[node]
        la = heights[node] - heights[a]
        lb = heights[node] - heights[b]
        return f"({rec(a)}:{la:g},{rec(b)}:{lb:g})"

    return rec(n + Z.shape[0] - 1) + ";"


def merged_group_newick(group_linkages: dict, group_labels: dict) -> str:
    """Stitch per-group trees into one newick (reference merges subcluster
    phylos with root-edge arithmetic, inferCNV_tumor_subclusters.R:602-641);
    here groups are joined under a common root."""
    parts = []
    for g, Z in group_linkages.items():
        labels = group_labels[g]
        if Z is None or len(labels) < 2:
            parts.extend(_sanitize(l) for l in labels)
        else:
            parts.append(linkage_to_newick(Z, labels)[:-1])  # strip ';'
    return "(" + ",".join(parts) + ");"
