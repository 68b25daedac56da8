"""Cell-cell distances for the Ward linkage of step 15.

Counterpart of infercnv_tpu/subcluster/distance.py (``pairwise_sq_dists``,
``pairwise_dists``, ``condensed_dists``, lines 49-73), with the same split:
up to 1,024 rows of a host array the Gram trick runs in float64 numpy (the
reference's host BLAS, closer to R's double-precision dist); above that, or
for a tensor, it runs in float32 on ``device`` (``torch.matmul``, a library
product that no TPU kernel computes in the reference either).  Not ported
yet: ``knn_indices``, which only the Leiden partition uses (ROADMAP A6).

The reference computes pairwise euclidean distances with parallelDist
(R/inferCNV_tumor_subclusters.R:191, 411, 472, 497, 582, 609).
"""

from __future__ import annotations

import numpy as np
import torch

from infercnv_tpu_torch.device import DeviceLike, resolve_device

#: up to this many rows of a host array the distances are float64 numpy
_HOST_GRAM_MAX = 1024


def pairwise_sq_dists(x, device: DeviceLike = None):
    """[C, C] squared euclidean distances of rows of x ([C, G]): float64
    numpy for a host array of at most 1,024 rows, else a float32 tensor on
    `device` (a tensor's own device when None)."""
    if not torch.is_tensor(x) and x.shape[0] <= _HOST_GRAM_MAX:
        xh = np.asarray(x, np.float64)
        sq = np.einsum("ij,ij->i", xh, xh)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (xh @ xh.T)
        return np.maximum(d2, 0.0)
    if torch.is_tensor(x) and device is None:
        xd = x.to(torch.float32)
    else:
        dev = resolve_device(device)
        xd = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    sq = (xd * xd).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (xd @ xd.T)
    return torch.clamp(d2, min=0.0)


def pairwise_dists(x, device: DeviceLike = None) -> np.ndarray:
    """Euclidean distance matrix (host float64 numpy, for linkage)."""
    d2 = pairwise_sq_dists(x, device)
    if torch.is_tensor(d2):
        d2 = d2.cpu().numpy()
    return np.sqrt(np.asarray(d2, np.float64))


def condensed_dists(x, device: DeviceLike = None) -> np.ndarray:
    """Condensed (scipy-style) distance vector for linkage."""
    d = pairwise_dists(x, device)
    iu = np.triu_indices(d.shape[0], k=1)
    return d[iu]
