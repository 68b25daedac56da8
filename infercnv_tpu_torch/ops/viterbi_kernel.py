"""Viterbi over padded sequences with chain restarts.

Counterpart of infercnv_tpu/ops/viterbi_pallas.py.  ``viterbi`` is the
wrapper of the CUDA kernels ``csrc/viterbi.cu``, which replace the TPU
kernel ``_viterbi_kernel`` (``_viterbi_pallas_call`` / ``viterbi_pallas``,
lines 77-271), for the i6 (S = 6) and i3 (S = 3) models; ``viterbi_plain``
is the same recursion in PyTorch, a Python loop over the sequence axis
vectorised over the batch.  ``viterbi_plan`` chooses the kernel's regime on
the host: a block a sequence, with the emissions computed ahead into a ring
in shared memory, for a batch of a few sequences an SM (the group means); a
thread a sequence for a batch that fills the card (cells mode).

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

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from infercnv_tpu_torch.ops import _build

#: launches of the CUDA kernels (the plain version does not count)
LAUNCHES = 0

#: positions a slot of the latency regime's ring and log (kChunk of
#: csrc/viterbi.cu: a warp's lanes), ring slots at most (kMaxRing), log slots
#: (kHist), and the shared memory before the ring (4 kMaxRing mbarriers, the
#: last state, a restart flag a ring slot)
RING_CHUNK, _MAX_RING, _LOG_SLOTS = 32, 16, 4
_RING_HEAD_BYTES = 4 * _MAX_RING * 8 + 16 + 4 * _MAX_RING
#: the latency regime's block: thread 0 runs the recursion, warp 4 packs the
#: backpointers from the recursion's log, six warps produce emissions into
#: a ring of _LATENCY_RING slots
_LATENCY_THREADS, _LATENCY_RING = 256, 8
#: the latency regime takes batches of up to this many sequences an SM
_LATENCY_PER_SM = 4
#: the throughput regime's blocks (kBatchThreads) and the most resident an
#: SM (its launch bound kBatchBlocksPerSm: at most 42 registers a thread)
_BATCH_THREADS, _BATCH_BLOCKS_PER_SM = 64, 24


@dataclasses.dataclass(frozen=True)
class ViterbiPlan:
    """A launch of csrc/viterbi.cu (see viterbi_plan)."""

    regime: str          # "latency" (a block a sequence) or "throughput"
    threads: int         # threads a block
    blocks: int          # the grid
    ring: int            # ring slots of RING_CHUNK positions (latency)
    bp_shared: bool      # backpointers and states in shared memory (latency)
    smem_bytes: int      # dynamic shared memory a block

    def launch_args(self) -> Tuple[int, ...]:
        """The plan as the C entry point takes it."""
        return (0 if self.regime == "latency" else 1, self.threads,
                self.blocks, self.ring, int(self.bp_shared), self.smem_bytes)


def _round16(v: int) -> int:
    return (v + 15) // 16 * 16


def latency_smem_bytes(S: int, L: int, ring: int, threads: int,
                       bp_shared: bool) -> int:
    """Shared memory of a latency block (latency_smem_bytes of
    csrc/viterbi.cu): the mbarriers and the last state, the ring and the
    log (a position's S values and flag padded to float4s), the backtrace's
    maps (8 bytes a thread), and with bp_shared the packed backpointers (2
    bytes a position) and the states (1 byte)."""
    slots = (ring + _LOG_SLOTS) * RING_CHUNK * (4 if S <= 3 else 8) * 4
    states = _round16(2 * L) + _round16(L) if bp_shared else 0
    return _RING_HEAD_BYTES + slots + 8 * threads + states


def viterbi_plan(B: int, L: int, S: int, smem_optin: int, n_sm: int,
                 regime: Optional[str] = None) -> ViterbiPlan:
    """Plan the Viterbi of B sequences of L positions and S states on a card
    whose blocks may opt in to smem_optin bytes of shared memory, with n_sm
    SMs.  Up to _LATENCY_PER_SM sequences an SM take the latency regime: a
    block a sequence, its backpointers in shared memory when they fit beside
    the ring, else in a [B, L] scratch in device memory (the same packed
    words).  Larger batches take the throughput regime: a thread a sequence
    in persistent blocks, as few an SM as leave the rounds over the batch
    as many as with the card full, so that the last round is not mostly
    empty.  regime overrides the choice, for measurements.  Raises on what
    the kernel or the card cannot take."""
    if S not in (3, 6) or L < 1 or B < 0 or n_sm < 1:
        raise ValueError(f"viterbi_plan: B={B}, L={L}, S={S}, n_sm={n_sm}")
    if regime is None:
        regime = "latency" if B <= _LATENCY_PER_SM * n_sm else "throughput"
    if regime == "latency":
        T, R = _LATENCY_THREADS, _LATENCY_RING
        ring_only = latency_smem_bytes(S, L, R, T, False)
        if ring_only > smem_optin:
            raise ValueError(f"viterbi_plan: the ring ({ring_only} bytes) "
                             f"exceeds {smem_optin} bytes")
        shared = latency_smem_bytes(S, L, R, T, True) <= smem_optin
        return ViterbiPlan("latency", T, B, R, shared,
                           latency_smem_bytes(S, L, R, T, shared))
    if regime != "throughput":
        raise ValueError(f"viterbi_plan: unknown regime {regime!r}")
    full = n_sm * _BATCH_BLOCKS_PER_SM * _BATCH_THREADS
    rounds = max(1, -(-B // full))
    per_sm = -(-B // (rounds * n_sm))
    blocks_per_sm = min(_BATCH_BLOCKS_PER_SM, -(-per_sm // _BATCH_THREADS))
    blocks = max(1, min(n_sm * blocks_per_sm, -(-B // _BATCH_THREADS)))
    return ViterbiPlan("throughput", _BATCH_THREADS, blocks, 0, False, 0)


def card_plan(B: int, L: int, S: int, device: torch.device,
              regime: Optional[str] = None) -> ViterbiPlan:
    """viterbi_plan on a CUDA device's own shared memory and SM count."""
    return viterbi_plan(B, L, S, *_build.card_limits(device), regime=regime)

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


def launch(x: torch.Tensor, lengths: torch.Tensor, sigma: torch.Tensor,
           bnd: torch.Tensor, means, log_delta, log_diag: float,
           log_off: float, plan: ViterbiPlan) -> torch.Tensor:
    """The kernel on x f32 and bnd int8 (nonzero where a chain restarts)
    [B, L], lengths int32 and sigma f32 [B], all contiguous on one CUDA
    device.  Returns the int8 states [B, L] (latency regime), or [L, B]
    (throughput regime, whose threads write neighbouring bytes)."""
    global LAUNCHES
    means = np.ascontiguousarray(np.asarray(means, np.float32).reshape(-1))
    log_delta = np.ascontiguousarray(np.asarray(log_delta, np.float32).reshape(-1))
    S = means.shape[0]
    B, L = x.shape
    _build.check_inputs("viterbi", x, bnd, lengths, sigma)
    lib = _build.library()
    shape = (B, L) if plan.regime == "latency" else (L, B)
    out = torch.empty(shape, dtype=torch.int8, device=x.device)
    # the packed backpointers: [L, B] (throughput), or [B, L rounded up to
    # 8] (latency, when they do not stay in shared memory)
    bp_shape = (shape if plan.regime == "throughput"
                else (B, (L + 7) // 8 * 8))
    bp = (None if plan.bp_shared else
          torch.empty(bp_shape, dtype=torch.int16, device=x.device))
    with torch.cuda.device(x.device):
        rc = lib.ic_viterbi(
            _build.ptr(x), _build.ptr(lengths), _build.ptr(sigma),
            _build.ptr(bnd), None if bp is None else _build.ptr(bp),
            _build.ptr(out), B, L, S, means.ctypes.data, log_delta.ctypes.data,
            float(np.float32(log_diag)), float(np.float32(log_off)),
            *plan.launch_args(), _build.stream_of(x))
    _build.check(rc, "viterbi")
    LAUNCHES += 1
    return out


def viterbi(x: torch.Tensor, lengths: torch.Tensor, sigma: torch.Tensor,
            boundaries: torch.Tensor, means, log_delta,
            log_diag: float, log_off: float,
            plan: Optional[ViterbiPlan] = None) -> torch.Tensor:
    """Viterbi over B padded sequences (see :func:`viterbi_plain` for the
    arguments).  CPU tensors take the plain version; CUDA tensors launch the
    kernel under ``plan`` (by default ``card_plan``'s), which in the
    throughput regime returns a transposed view of its [L, B] states."""
    if x.device.type == "cpu":
        return viterbi_plain(x, lengths, sigma, boundaries, means, log_delta,
                             log_diag, log_off)
    S = np.asarray(means).reshape(-1).shape[0]
    if S not in (3, 6):
        raise ValueError(f"viterbi: the CUDA kernel takes the i3 or i6 model "
                         f"(S = 3 or 6), got S={S}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"viterbi: x must be f32 [B, L], got {x.dtype} {tuple(x.shape)}")
    B, L = x.shape
    if lengths.shape != (B,) or sigma.shape != (B,) or boundaries.shape != (B, L):
        raise ValueError("viterbi: lengths/sigma must be [B] and boundaries [B, L]")
    if plan is None:
        plan = card_plan(B, L, S, x.device)
    # the kernel reads a flag as nonzero: 1-byte flags pass as they are
    bnd = (boundaries.view(torch.int8) if boundaries.dtype in (torch.int8, torch.uint8)
           else (boundaries != 0).to(torch.int8))
    lens = lengths.to(torch.int32).contiguous()
    sig = sigma.to(torch.float32).contiguous()
    out = launch(x.contiguous(), lens, sig, bnd.contiguous(), means, log_delta,
                 log_diag, log_off, plan)
    return out if plan.regime == "latency" else out.t()
