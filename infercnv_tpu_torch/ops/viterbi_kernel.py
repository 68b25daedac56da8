"""Viterbi over padded sequences with chain restarts.

Counterpart of infercnv_tpu/ops/viterbi_pallas.py.  ``viterbi`` is the
wrapper of the CUDA kernel ``csrc/viterbi.cu``, which replaces the TPU
kernel ``_viterbi_kernel`` (``_viterbi_pallas_call`` / ``viterbi_pallas``,
lines 77-271), for the i6 (S = 6) and i3 (S = 3) models; ``viterbi_plain``
is the same recursion in PyTorch, a Python loop over the sequence axis
vectorised over the batch.

The transitions are uniform (diagonal ``1-(S-1)t``, off-diagonal ``t``;
reference .get_HMM R/inferCNV_HMM.R:230-265), so a forward step needs only
the running max over states:

    nu_s <- max(nu_s + log_diag, max_j nu_j + log_off) + em_s

with backpointer ties going to the lower state index, as R's which.max.
The emission is the reference's unnormalised ``-log(-logSF(|x-mu|/sigma))``
(Viterbi.dthmm.adj R/inferCNV_HMM.R:1129-1133; the per-position normaliser
is the same for every state, so no decision changes without it).
"""

from __future__ import annotations

import numpy as np
import torch

from infercnv_tpu_torch.ops import _build

#: launches of the CUDA kernel (the plain version does not count)
LAUNCHES = 0

# Chebyshev-derived polynomial of f(z) = -log Phi(-z) on z in [0, 6] in
# u = z/3 - 1, highest order last (infercnv_tpu/ops/viterbi_pallas.py:53-59);
# the same coefficients are written out in csrc/viterbi.cu
_LOGSF_POLY = (
    6.6077262216734844, 9.849295972346816, 4.182483637492412,
    0.14161773540308858, -0.06389011554893194, 0.02750005245776225,
    -0.010807058987670455, 0.003606634430994035, -0.0008351692702736372,
    5.6785208915892025e-06, 0.00016607633590841293, -0.0002004534568855845,
    0.00012466292805241087, -1.4737718057576076e-05, -1.018850375361854e-05,
)
_HALF_LOG_2PI = 0.9189385332046727


def log_sf_std_normal(z: torch.Tensor) -> torch.Tensor:
    """log P(Z > z) for z >= 0 in float32: the polynomial below 6, the
    4-term asymptotic series above (a bare log(erfc) underflows near 9)."""
    u = z * np.float32(1.0 / 3.0) - 1.0
    poly = torch.full_like(z, float(np.float32(_LOGSF_POLY[-1])))
    for c in _LOGSF_POLY[-2::-1]:
        poly = poly * u + float(np.float32(c))
    zc = torch.clamp(z, min=6.0)
    inv2 = 1.0 / (zc * zc)
    series = 1.0 + inv2 * (-1.0 + inv2 * (3.0 + inv2 * (-15.0 + inv2 * 105.0)))
    asym = 0.5 * zc * zc + torch.log(zc) + float(np.float32(_HALF_LOG_2PI)) - torch.log(series)
    return -torch.where(z < 6.0, poly, asym)


def transition_logs(S: int, t: float):
    """(log_diag, log_off, log_delta[S]) of the uniform i6/i3 chain."""
    log_diag = float(np.log1p(-(S - 1) * t))
    log_off = float(np.log(t))
    delta = np.full(S, t)
    delta[(S - 1) // 2] = 1.0 - (S - 1) * t
    return log_diag, log_off, np.log(delta).astype(np.float32)


def _first_max(a: torch.Tensor):
    """Max and first argmax over the last (state) axis, R's which.max."""
    m = a[:, 0]
    am = torch.zeros_like(m, dtype=torch.int64)
    for s in range(1, a.shape[1]):
        better = a[:, s] > m
        m = torch.where(better, a[:, s], m)
        am = torch.where(better, torch.full_like(am, s), am)
    return m, am


def viterbi_plain(x: torch.Tensor, lengths: torch.Tensor, sigma: torch.Tensor,
                  boundaries: torch.Tensor, means, log_delta,
                  log_diag: float, log_off: float) -> torch.Tensor:
    """x [B, L] f32; lengths [B]; sigma [B]; boundaries [B, L] (nonzero
    where a new chain starts); means/log_delta [S].  Returns 1-based int8
    states [B, L]; positions at or past a sequence's length repeat its last
    state."""
    dev = x.device
    B, L = x.shape
    means = torch.as_tensor(means, dtype=torch.float32, device=dev)
    log_delta = torch.as_tensor(log_delta, dtype=torch.float32, device=dev)
    S = means.shape[0]
    sidx = torch.arange(S, device=dev)[None, :].expand(B, S)
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int64)
    bnd = torch.as_tensor(boundaries, device=dev) != 0
    sig = torch.as_tensor(sigma, dtype=torch.float32, device=dev)[:, None]
    f_diag = torch.tensor(log_diag, dtype=torch.float32, device=dev)
    f_off = torch.tensor(log_off, dtype=torch.float32, device=dev)

    def emission(col):
        z = torch.abs(col[:, None] - means[None, :]) / sig
        return -torch.log(-log_sf_std_normal(z))          # [B, S]

    nu = log_delta[None, :] + emission(x[:, 0])
    bps = torch.empty((L, B, S), dtype=torch.int8, device=dev)
    for i in range(1, L):
        em = emission(x[:, i])
        m_all, a_all = _first_max(nu)
        a_all = a_all[:, None].expand(B, S)
        stay = nu + f_diag
        move = (m_all + f_off)[:, None]
        best = torch.maximum(stay, move)
        bp = torch.where(stay > move, sidx,
                         torch.where(move > stay, a_all, torch.minimum(sidx, a_all)))
        bv = bnd[:, i, None]
        nu_next = torch.where(bv, log_delta[None, :] + em, best + em)
        valid = (i < lengths)[:, None]
        nu = torch.where(valid, nu_next, nu)
        bp = torch.where(bv, torch.where(sidx == 0, a_all, sidx), bp)
        bps[i] = torch.where(valid, bp, sidx).to(torch.int8)
    _, y = _first_max(nu)
    out = torch.empty((B, L), dtype=torch.int8, device=dev)
    out[:, L - 1] = (y + 1).to(torch.int8)
    for i in range(L - 2, -1, -1):
        row = bps[i + 1].to(torch.int64)
        y_bp = row.gather(1, y[:, None])[:, 0]
        # a restart flag at or past the sequence's length is ignored
        # (the reference's XLA path masks it, viterbi_pack.py:214)
        y = torch.where(bnd[:, i + 1] & (i + 1 < lengths), row[:, 0], y_bp)
        out[:, i] = (y + 1).to(torch.int8)
    return out


def viterbi(x: torch.Tensor, lengths: torch.Tensor, sigma: torch.Tensor,
            boundaries: torch.Tensor, means, log_delta,
            log_diag: float, log_off: float) -> torch.Tensor:
    """Viterbi over B padded sequences (see :func:`viterbi_plain` for the
    arguments).  CPU tensors take the plain version; CUDA tensors launch the
    kernel, which keeps its [L, S, B] int8 backpointers in a scratch
    allocated here."""
    if x.device.type == "cpu":
        return viterbi_plain(x, lengths, sigma, boundaries, means, log_delta,
                             log_diag, log_off)
    global LAUNCHES
    means = np.asarray(means, np.float32).reshape(-1)
    log_delta = np.asarray(log_delta, np.float32).reshape(-1)
    S = means.shape[0]
    if S not in (3, 6):
        raise ValueError(f"viterbi: the CUDA kernel takes the i3 or i6 model "
                         f"(S = 3 or 6), got S={S}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"viterbi: x must be f32 [B, L], got {x.dtype} {tuple(x.shape)}")
    B, L = x.shape
    if lengths.shape != (B,) or sigma.shape != (B,) or boundaries.shape != (B, L):
        raise ValueError("viterbi: lengths/sigma must be [B] and boundaries [B, L]")
    x_lb = x.t().contiguous()
    bnd_lb = (boundaries != 0).to(torch.int8).t().contiguous()
    lens = lengths.to(torch.int32).contiguous()
    sig = sigma.to(torch.float32).contiguous()
    _build.check_inputs("viterbi", x_lb, bnd_lb, lens, sig)
    lib = _build.library()
    bp = torch.empty((L, S, B), dtype=torch.int8, device=x.device)
    out = torch.empty((L, B), dtype=torch.int8, device=x.device)
    c_means = np.ascontiguousarray(means)   # host arrays, read during the call
    c_delta = np.ascontiguousarray(log_delta)
    with torch.cuda.device(x.device):
        rc = lib.ic_viterbi(
            _build.ptr(x_lb), _build.ptr(lens), _build.ptr(sig),
            _build.ptr(bnd_lb), _build.ptr(bp), _build.ptr(out), B, L, S,
            c_means.ctypes.data, c_delta.ctypes.data,
            float(np.float32(log_diag)), float(np.float32(log_off)),
            _build.stream_of(x_lb))
    _build.check(rc, "viterbi")
    LAUNCHES += 1
    return out.t()
