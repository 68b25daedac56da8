"""Plain reference of what the timed path computes, in plain PyTorch.

The default analysis of inferCNV (steps 4-14 and the HMM) as the
reference R package defines it, written directly from its semantics:

* normalise each cell to the norm factor, log2(x + 1);
* subtract the reference groups by bounds (values inside the groups'
  [min, max] of means go to 0, others lose the nearer bound,
  ``.subtract_expr`` R/inferCNV_ops.R:1742-1786), clip to +-3;
* smooth each chromosome apart: the pyramidal window renormalised over the
  taps inside the chromosome (``.smooth_helper`` :2483-2532), or the 10 Mbp
  coordinate window (``.smooth_helper_by_coordinates`` :2582-2622);
* centre each cell on its median; subtract the reference groups' residual
  means by bounds; exp2;
* denoise: values inside mean_ref +- sd_amplifier * mean per-cell sd of the
  reference cells go to mean_ref (``clear_noise_via_ref_mean_sd``
  :2302-2346);
* the HMM: chromosomes are independent chains with the uniform transitions
  of ``.get_HMM`` (R/inferCNV_HMM.R:230-265) and the emission
  -log(-log P(Z > |x - mu| / sigma)) of ``Viterbi.dthmm.adj`` (:1101-1176),
  sigma the median of the state sds; the i3 model from the reference cells'
  residual (i3HMM.R:17-156: mean, sd, delta = |qnorm(p, sd)|).

Each smooth is a dense matrix a chromosome, applied as a matrix product.
By default everything runs in float64.  The control is the reference in
TF32, the next precision below the configuration's float32 with TF32 off:
``Reference(..., dtype=torch.float32, tf32=True)`` rounds both operands of
every matrix product to TF32's 10 mantissa bits (to nearest), as a TF32
tensor-core product does, and holds every other value it computes, the
HMM's emissions and running scores too, at that precision.

Imports torch and numpy only: nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from cnvbench.genomes import Genome


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero (the magnitude bits are rounded; signs keep)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def pyramidal_block(n: int, window: int) -> np.ndarray:
    """[n, n] operator W of one chromosome: y = x @ W, the triangular window
    c(1:t, t+1, t:1) renormalised over the taps inside the chromosome."""
    if n == 1 or window < 2:
        return np.eye(n)
    t = (window - 1) // 2
    d = np.arange(n)[:, None] - np.arange(n)[None, :]     # source - output
    k = np.where(np.abs(d) <= t, t + 1 - np.abs(d), 0).astype(np.float64)
    return k / k.sum(axis=0, keepdims=True)


def coordinate_block(start: np.ndarray, stop: np.ndarray,
                     window: int) -> np.ndarray:
    """[n, n] operator of one chromosome for the bp-coordinate smoother:
    for output gene g at midpoint p, the genes lying inside (p - L, p + L)
    weigh 1 - |mid - p| / L; the span is widened by half their number on
    each side (clamped to the chromosome), where genes of the span not inside
    weigh 0.1; the weights are divided by their sum."""
    n = start.shape[0]
    mid = (start + stop) / 2.0
    p = mid[:, None]
    inside = (start[None, :] > p - window) & (stop[None, :] < p + window)
    empty = ~inside.any(axis=1)
    inside[empty, np.flatnonzero(empty)] = True
    cnt = inside.sum(axis=1)
    first = inside.argmax(axis=1)
    last = n - 1 - inside[:, ::-1].argmax(axis=1)
    lo = np.maximum(0, first - cnt // 2)
    hi = np.minimum(n - 1, last + cnt // 2)
    j = np.arange(n)[None, :]
    w = np.where((j >= lo[:, None]) & (j <= hi[:, None]), 0.1, 0.0)
    w = np.where(inside, 1.0 - np.abs(mid[None, :] - p) / window, w)
    w = w / w.sum(axis=1, keepdims=True)
    return w.T                                             # [source, output]


def smoothing_blocks(genome: Genome, method: str, window: int) -> list:
    """(begin, end, W [n, n]) for each chromosome of the genome."""
    out = []
    for b, e in genome.chr_ranges():
        if method == "coordinates":
            w = coordinate_block(genome.start[b:e], genome.stop[b:e], window)
        elif method == "pyramidinal":
            w = pyramidal_block(e - b, window)
        else:
            raise ValueError(f"unknown smoothing method {method!r}")
        out.append((b, e, w))
    return out


def band_nonzeros(genome: Genome, method: str, window: int) -> int:
    """Nonzero weights of the whole smoothing operator."""
    return int(sum(np.count_nonzero(w) for _b, _e, w in
                   smoothing_blocks(genome, method, window)))


def median_rows(x: torch.Tensor) -> torch.Tensor:
    """Median of each row: the middle value, or the mean of the two."""
    s, _ = torch.sort(x, dim=1)
    n = x.shape[1]
    if n % 2:
        return s[:, n // 2]
    return (s[:, n // 2 - 1] + s[:, n // 2]) * 0.5


def median_value(v: torch.Tensor) -> torch.Tensor:
    return median_rows(v.reshape(1, -1))[0]


def subtract_bounds(x: torch.Tensor, group_means: torch.Tensor) -> torch.Tensor:
    lo, hi = group_means.amin(dim=0), group_means.amax(dim=0)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x < lo, x - lo, torch.where(x > hi, x - hi, zero))


class Stats:
    """A sample's reference statistics."""

    def __init__(self, nf, mean_log, mean_resid, mean_ref, sd_ref):
        self.nf = nf                    # norm factor (a float)
        self.mean_log = mean_log        # [K, G] group means of log counts
        self.mean_resid = mean_resid    # [K, G] group means of the smooth
        self.mean_ref = mean_ref        # denoise centre (0-d tensor)
        self.sd_ref = sd_ref            # denoise half-width (0-d tensor)


class Reference:
    """The reference pipeline of one configuration on one device."""

    def __init__(self, config: dict, genome: Genome, device,
                 dtype: torch.dtype = torch.float64, tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("tf32 rounding applies to float32")
        if (config["engine"].get("ref_subtract_use_bounds", True) is not True
                or config["engine"].get("center_method", "median") != "median"):
            raise ValueError("the reference takes bounds subtraction and median centring")
        self.cfg = config["engine"]
        self.hmm_cfg = config["hmm"]
        self.genome = genome
        self.device = torch.device(device)
        self.dtype = dtype
        self.tf32 = tf32
        self.blocks = [(b, e, torch.as_tensor(w, dtype=dtype, device=self.device))
                       for b, e, w in smoothing_blocks(
                           genome, self.cfg["smooth_method"],
                           int(self.cfg["window_length"]))]

    # ---- arithmetic -----------------------------------------------------

    def _q(self, a: torch.Tensor) -> torch.Tensor:
        """A computed value at the reference's precision."""
        return round_tf32(a) if self.tf32 else a

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._q(self._q(a) @ self._q(b))

    def _onehot(self, labels: torch.Tensor, k: int) -> torch.Tensor:
        oh = torch.zeros((k, labels.shape[0]), dtype=self.dtype, device=self.device)
        oh[labels, torch.arange(labels.shape[0], device=self.device)] = 1
        return oh

    def group_sums(self, x: torch.Tensor, labels: torch.Tensor, k: int):
        """([k, G] sums of x's rows by label, [k] counts)."""
        oh = self._onehot(labels, k)
        return self._mm(oh, x), oh.sum(dim=1)

    def counts(self, c: torch.Tensor) -> torch.Tensor:
        if c.dtype == torch.uint16:
            c = c.view(torch.int16).to(torch.int32) & 0xFFFF
        return c.to(self.dtype)

    def norm_factor(self, counts: torch.Tensor, block: int = 8192) -> float:
        """Median library size of the sample's cells."""
        sizes = torch.cat([self.counts(counts[a:a + block]).sum(dim=1)
                           for a in range(0, counts.shape[0], block)])
        return float(median_value(sizes.to(torch.float64)))

    def log_norm(self, counts: torch.Tensor, nf: float) -> torch.Tensor:
        c = self.counts(counts)
        q = self._q
        return q(torch.log2(q(q(c / q(c.sum(dim=1, keepdim=True))) * nf) + 1.0))

    def smooth(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.empty_like(x)
        for b, e, w in self.blocks:
            y[:, b:e] = self._mm(x[:, b:e], w)
        return y

    def _centred_smooth(self, counts, nf, mean_log) -> torch.Tensor:
        mct = float(self.cfg["max_centered_threshold"])
        x = torch.clamp(self._q(subtract_bounds(self.log_norm(counts, nf), mean_log)),
                        -mct, mct)
        y = self.smooth(x)
        return self._q(y - median_rows(y)[:, None])

    # ---- the pipeline -----------------------------------------------------

    def ref_stats(self, ref_counts: torch.Tensor, labels: torch.Tensor, k: int,
                  nf: float) -> Stats:
        """Statistics of the reference cells (labels: their group, 0..k-1)."""
        q = self._q
        s, n = self.group_sums(self.log_norm(ref_counts, nf), labels, k)
        mean_log = q(s / n[:, None])
        y = self._centred_smooth(ref_counts, nf, mean_log)
        s, n = self.group_sums(y, labels, k)
        mean_resid = q(s / n[:, None])
        final = q(torch.exp2(q(subtract_bounds(y, mean_resid))))
        mean_ref = q(final.mean())
        sd_ref = q(q(q(final.std(dim=1, correction=1)).mean())
                   * float(self.cfg["sd_amplifier"]))
        return Stats(nf, mean_log, mean_resid, mean_ref, sd_ref)

    def residual(self, counts: torch.Tensor, st: Stats):
        """(residual before denoise, final residual) of cells' counts."""
        y = self._centred_smooth(counts, st.nf, st.mean_log)
        pre = self._q(torch.exp2(self._q(subtract_bounds(y, st.mean_resid))))
        if not self.cfg.get("denoise", True):
            return pre, pre
        inside = (pre > st.mean_ref - st.sd_ref) & (pre < st.mean_ref + st.sd_ref)
        return pre, torch.where(inside, st.mean_ref.to(pre.dtype), pre)

    # ---- the HMM ------------------------------------------------------------

    def hmm(self, ref_pre: torch.Tensor = None) -> Tuple[np.ndarray, float, float]:
        """(state means, emission sigma, t): i6 from the configuration, i3
        from the reference cells' residual before denoise."""
        h = self.hmm_cfg
        t = float(h["t"])
        if h["type"] == "i6":
            return (np.asarray(h["means"], np.float64),
                    float(np.median(np.asarray(h["sds"], np.float64))), t)
        v = ref_pre.to(torch.float64).reshape(-1)
        mu = float(v.mean())
        sigma = float(v.std(correction=1))
        z = float(torch.special.ndtri(torch.tensor(float(h["p_val"]),
                                                  dtype=torch.float64)))
        delta = abs(z) * sigma
        return np.array([mu - delta, mu, mu + delta]), sigma, t

    def _emission(self, x: torch.Tensor, means: torch.Tensor, sigma: float):
        z = torch.abs(x[..., None] - means) / sigma
        return -torch.log(-torch.special.log_ndtr(-z))

    def _padded(self, x: torch.Tensor):
        """x [B, G] as [B, n_chr, Lmax] with the chromosome lengths."""
        ranges = self.genome.chr_ranges()
        L = max(e - b for b, e in ranges)
        xp = torch.zeros((x.shape[0], len(ranges), L), dtype=x.dtype, device=x.device)
        for c, (b, e) in enumerate(ranges):
            xp[:, c, :e - b] = x[:, b:e]
        lens = torch.tensor([e - b for b, e in ranges], device=x.device)
        return xp, lens

    def _chain(self, S: int, t: float):
        log_diag = math.log1p(-(S - 1) * t)
        log_off = math.log(t)
        delta = np.full(S, t)
        delta[(S - 1) // 2] = 1.0 - (S - 1) * t
        return log_diag, log_off, torch.as_tensor(np.log(delta), dtype=self.dtype,
                                                  device=self.device)

    def viterbi(self, x: torch.Tensor, means, sigma: float, t: float,
                states: bool = True):
        """Best log-score of each row's chromosomes [B, n_chr] and, with
        states, the 1-based int8 states [B, G] of a best path (ties to the
        lower state)."""
        means = torch.as_tensor(means, dtype=self.dtype, device=self.device)
        S = means.shape[0]
        log_diag, log_off, log_delta = self._chain(S, t)
        xp, lens = self._padded(x.to(self.dtype))
        B, C, L = xp.shape
        q = self._q
        nu = q(log_delta + q(self._emission(xp[:, :, 0], means, sigma)))
        bps = (torch.empty((L, B, C, S), dtype=torch.int8, device=self.device)
               if states else None)
        sidx = torch.arange(S, device=self.device)
        for i in range(1, L):
            m, am = nu.max(dim=2, keepdim=True)
            stay, move = nu + log_diag, m + log_off
            nxt = q(q(torch.maximum(q(stay), q(move)))
                    + q(self._emission(xp[:, :, i], means, sigma)))
            valid = (i < lens)[None, :, None]
            nu = torch.where(valid, nxt, nu)
            if states:
                bps[i] = torch.where(stay >= move, sidx, am).to(torch.int8)
        best, y = nu.max(dim=2)
        if not states:
            return best, None
        # back from each chromosome's last position (nu stopped there)
        path = torch.empty((B, C, L), dtype=torch.int64, device=self.device)
        for i in range(L - 1, -1, -1):
            path[:, :, i] = y
            if i > 0:
                back = bps[i].to(torch.int64).gather(2, y[..., None])[..., 0]
                y = torch.where((i < lens)[None, :], back, y)
        out = torch.empty(x.shape, dtype=torch.int8, device=self.device)
        for c, (b, e) in enumerate(self.genome.chr_ranges()):
            out[:, b:e] = (path[:, c, :e - b] + 1).to(torch.int8)
        return best, out

    def path_score(self, x: torch.Tensor, states: torch.Tensor, means,
                   sigma: float, t: float) -> torch.Tensor:
        """Log-score [B, n_chr] of given 1-based states on x [B, G] under
        the same chains."""
        means = torch.as_tensor(means, dtype=self.dtype, device=self.device)
        S = means.shape[0]
        log_diag, log_off, log_delta = self._chain(S, t)
        z = states.to(device=self.device, dtype=torch.int64) - 1
        if bool(((z < 0) | (z >= S)).any()):
            return torch.full((x.shape[0], len(self.genome.chr_ranges())),
                              -math.inf, dtype=self.dtype, device=self.device)
        em = self._emission(x.to(self.dtype), means, sigma).gather(2, z[..., None])[..., 0]
        first = torch.zeros(x.shape[1], dtype=torch.bool, device=self.device)
        for b, _e in self.genome.chr_ranges():
            first[b] = True
        same = torch.ones_like(z, dtype=torch.bool)
        same[:, 1:] = z[:, 1:] == z[:, :-1]
        trans = torch.where(first[None, :], log_delta[z],
                            torch.where(same, torch.full((), log_diag, dtype=self.dtype,
                                                         device=self.device),
                                        torch.full((), log_off, dtype=self.dtype,
                                                   device=self.device)))
        per_gene = em + trans
        chr_ids = torch.as_tensor(self.genome.chr_ids, dtype=torch.int64,
                                  device=self.device)
        out = torch.zeros((x.shape[0], int(chr_ids.max()) + 1), dtype=self.dtype,
                          device=self.device)
        return out.index_add_(1, chr_ids, per_gene)


def chunks(n: int, size: int) -> List[Tuple[int, int]]:
    return [(a, min(n, a + size)) for a in range(0, n, size)]
