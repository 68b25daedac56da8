"""Cell-cell distances and exact kNN of step 15.

Counterpart of infercnv_tpu/subcluster/distance.py (``pairwise_sq_dists``,
``pairwise_dists``, ``condensed_dists``, ``knn_indices``, lines 49-113),
with the same split for the distances: up to 1,024 rows of a host array the
Gram trick runs in float64 numpy (the reference's host BLAS, closer to R's
double-precision dist); above that, or for a tensor, it runs in float32 on
``device``.  The Gram products are ``torch.matmul``, a library product that
no TPU kernel computes in the reference either (XLA's dot there).

``knn_indices`` is exact: the squared distances of a block of query rows to
every row, and their k smallest, up to 16,384 rows in one block, above that
in blocks of 2,048 query rows, so only a [block, C] slab is ever held.  Ties
go to the lower column, as ``jax.lax.top_k`` breaks them: the k smallest of
the int64 keys (bits of the non-negative f32 distance << 32 | column), whose
order is the distances' with the column as tie-break.

The reference computes pairwise euclidean distances with parallelDist
(R/inferCNV_tumor_subclusters.R:191, 411, 472, 497, 582, 609) and kNN with
RANN's kd-tree (``nn2``, :726).
"""

from __future__ import annotations

import numpy as np
import torch

from infercnv_tpu_torch.device import DeviceLike, resolve_device

#: up to this many rows of a host array the distances are float64 numpy
_HOST_GRAM_MAX = 1024
#: query rows per kNN block above _KNN_ONESHOT_MAX rows
_KNN_BLOCK = 2048
#: up to this many rows the kNN takes every query row in one block
_KNN_ONESHOT_MAX = 16384


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


def _knn_block(xq: torch.Tensor, x: torch.Tensor, sq_all: torch.Tensor,
               k: int) -> torch.Tensor:
    """Columns of the k smallest squared distances of each row of xq [B, G]
    to the rows of x [C, G], ascending, ties to the lower column."""
    sq_q = (xq * xq).sum(dim=1)
    d2 = sq_q[:, None] + sq_all[None, :] - 2.0 * (xq @ x.T)
    # +0.0 for every d2 <= 0 (a -0.0 would have the sign bit set)
    d2 = torch.where(d2 > 0, d2, torch.zeros((), dtype=d2.dtype, device=d2.device))
    cols = torch.arange(x.shape[0], dtype=torch.int64, device=x.device)
    keys = (d2.view(torch.int32).to(torch.int64) << 32) | cols[None, :]
    return torch.topk(keys, k, dim=1, largest=False, sorted=True).values & 0xFFFFFFFF


def knn_indices(x, k: int, device: DeviceLike = None) -> torch.Tensor:
    """Exact k nearest neighbours of every row of x ([C, G]), self included
    (as RANN::nn2 returns the query point as neighbour 1): int32 [C, k] on
    the device, nearest first.  x is a tensor (used on its own device when
    `device` is None) or a host array (moved to `device`)."""
    if torch.is_tensor(x) and device is None:
        xd = x.to(torch.float32)
    else:
        xd = (x if torch.is_tensor(x)
              else torch.as_tensor(np.array(x, np.float32))).to(
                  device=resolve_device(device), dtype=torch.float32)
    xd = xd.contiguous()
    C = xd.shape[0]
    sq_all = (xd * xd).sum(dim=1)
    if C <= _KNN_ONESHOT_MAX:
        return _knn_block(xd, xd, sq_all, k).to(torch.int32)
    out = torch.empty((C, k), dtype=torch.int32, device=xd.device)
    for b in range(0, C, _KNN_BLOCK):
        out[b:b + _KNN_BLOCK] = _knn_block(xd[b:b + _KNN_BLOCK], xd, sq_all, k)
    return out
