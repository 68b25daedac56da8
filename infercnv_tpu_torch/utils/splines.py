"""Penalized smoothing spline with GCV, a stand-in for R's smooth.spline.

Copied from infercnv_tpu/utils/splines.py (all of it; numpy and scipy).

The reference fits mean-variance and dropout trends with
``smooth.spline`` (e.g. R/inferCNV_meanVarSim.R:27-31,
R/inferCNV_simple_sim.R:303).  Here: a cubic P-spline (B-spline basis with a
second-difference penalty on coefficients) with the penalty weight chosen by
generalized cross-validation — same smoother family, host-side fit (the data
are tiny: one point per gene), with a dense-grid export so device code can
evaluate the trend by linear interpolation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
from scipy.interpolate import BSpline


def _nknots(n: int) -> int:
    """Knot-count heuristic in the spirit of R's .nknots.smspl."""
    if n < 50:
        return max(4, n)
    a1, a2, a3, a4 = np.log2(50), np.log2(100), np.log2(140), np.log2(200)
    if n < 200:
        k = 2 ** (a1 + (a2 - a1) * (n - 50) / 150)
    elif n < 800:
        k = 2 ** (a2 + (a3 - a2) * (n - 200) / 600)
    elif n < 3200:
        k = 2 ** (a3 + (a4 - a3) * (n - 800) / 2400)
    else:
        k = 200 + (n - 3200) ** 0.2
    return int(min(max(int(k), 10), 300))


@dataclasses.dataclass
class SmoothingSpline:
    knots: np.ndarray          # full (padded) knot vector
    coef: np.ndarray           # B-spline coefficients
    x_min: float
    x_max: float
    lam: float

    def predict(self, x) -> np.ndarray:
        x = np.atleast_1d(np.asarray(x, np.float64))
        xc = np.clip(x, self.x_min, self.x_max)  # linear-ish extrapolation by clamping
        spl = BSpline(self.knots, self.coef, 3, extrapolate=True)
        y = spl(xc)
        # linear extrapolation beyond the data range using boundary slope
        eps = 1e-6 * max(self.x_max - self.x_min, 1.0)
        lo = x < self.x_min
        hi = x > self.x_max
        if np.any(lo):
            s = (spl(self.x_min + eps) - spl(self.x_min)) / eps
            y[lo] = spl(self.x_min) + s * (x[lo] - self.x_min)
        if np.any(hi):
            s = (spl(self.x_max) - spl(self.x_max - eps)) / eps
            y[hi] = spl(self.x_max) + s * (x[hi] - self.x_max)
        return y

    def dense_grid(self, n: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
        """(grid_x, grid_y) for evaluation by linear interpolation."""
        gx = np.linspace(self.x_min, self.x_max, n)
        return gx, self.predict(gx)


def fit_smoothing_spline(x, y, w: Optional[np.ndarray] = None,
                         nknots: Optional[int] = None) -> SmoothingSpline:
    """Fit y ~ s(x) with GCV-selected penalty.

    Duplicate x values are collapsed to their (weighted) mean, mirroring
    smooth.spline's handling of ties.
    """
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    if w is None:
        w = np.ones_like(x)
    else:
        w = np.asarray(w, np.float64).ravel()
    # drop non-finite AND zero/negative-weight points (a zero total weight
    # at one unique x would 0/0-NaN the tie collapse and poison every
    # coefficient)
    ok = np.isfinite(x) & np.isfinite(y) & np.isfinite(w) & (w > 0)
    x, y, w = x[ok], y[ok], w[ok]
    if x.size == 0:
        raise ValueError("fit_smoothing_spline: no finite positively-"
                         "weighted (x, y) points to fit")
    order = np.argsort(x, kind="stable")
    x, y, w = x[order], y[order], w[order]
    # collapse ties
    ux, inv = np.unique(x, return_inverse=True)
    wsum = np.bincount(inv, weights=w)
    ywmean = np.bincount(inv, weights=w * y) / wsum
    x, y, w = ux, ywmean, wsum
    n = x.size
    if n < 4:
        # degenerate tiny data: weighted LINEAR least squares (constant
        # when a single unique x) — a flat mean would silently erase a
        # perfect linear trend; R's smooth.spline refuses n<4 outright
        if n == 1:
            slope, icept = 0.0, float(y[0])
        else:
            xm = float(np.average(x, weights=w))
            ym = float(np.average(y, weights=w))
            den = float(np.sum(w * (x - xm) ** 2))
            slope = float(np.sum(w * (x - xm) * (y - ym)) / den) if den > 0 else 0.0
            icept = ym - slope * xm
        span = max(float(x[-1] - x[0]), 1e-9)
        knots = np.r_[[x[0]] * 4, [x[0] + span] * 4]
        # a degree-3 B-spline on one span with coefficients on the line
        # reproduces the line exactly (Greville abscissae)
        grev = x[0] + span * np.array([0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0])
        coef = icept + slope * grev
        return SmoothingSpline(knots, coef, float(x[0]), float(x[-1]), 0.0)

    K = nknots or _nknots(n)
    K = min(K, n)
    # interior knots at quantiles of x
    qs = np.linspace(0, 1, K)
    kq = np.quantile(x, qs)
    kq = np.unique(kq)
    t = np.r_[[kq[0]] * 3, kq, [kq[-1]] * 3]
    nb = len(kq) + 2  # number of cubic B-spline basis functions

    # design matrix
    B = BSpline.design_matrix(x, t, 3).toarray()  # [n, nb]
    D = np.diff(np.eye(nb), n=2, axis=0)          # second-difference penalty
    P = D.T @ D
    W = w
    BtWB = B.T @ (B * W[:, None])
    BtWy = B.T @ (W * y)

    best = None
    for lam in np.logspace(-6, 6, 25):
        A = BtWB + lam * P
        try:
            coef = np.linalg.solve(A, BtWy)
            # effective dof = tr(B (A^-1) B^T W) = tr(A^-1 BtWB)
            edof = float(np.trace(np.linalg.solve(A, BtWB)))
        except np.linalg.LinAlgError:
            continue
        resid = y - B @ coef
        rss = float(np.sum(W * resid ** 2))
        denom = max(n - edof, 1e-8)
        gcv = n * rss / denom ** 2
        if best is None or gcv < best[0]:
            best = (gcv, lam, coef)
    _, lam, coef = best
    return SmoothingSpline(t, coef, float(x[0]), float(x[-1]), float(lam))
