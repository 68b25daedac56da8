"""The scheme of the port's Viterbi kernels (csrc/viterbi.cu), replayed in
numpy on the CPU, where the kernels cannot run: the packed backpointer word
(the argmax and the mask of the states that took the move), the first-max
tree, the latency regime's emission ring between producer warps and the
consumer thread, and the host launch plan (ops/viterbi_kernel.py
viterbi_plan) against an H100's limits.  The replays are held to the port's
plain version (states equal, torch.equal) and, where the reference's kernel
masks its restart flags as the port does, to the interpreted Pallas kernel
of the JAX package."""

import itertools

import numpy as np
import pytest
import torch

from infercnv_tpu.ops.viterbi_pallas import viterbi_pallas
from infercnv_tpu_torch.ops import viterbi_kernel as tvit

from torch_port_util import MEANS, MEANS_ROUND

#: an H100: shared memory a block may opt in to, and SMs
H100_SMEM, H100_SMS = 232_448, 132
#: i3 means (R/inferCNV_i3HMM.R's loss / neutral / gain around 1)
MEANS_I3 = np.array([0.5, 1.0, 1.5])


def emissions(x: np.ndarray, sigma: np.ndarray, means) -> np.ndarray:
    """[B, L, S] f32 emissions, the plain version's function of each
    position (what a producer lane computes)."""
    m = torch.as_tensor(np.asarray(means, np.float32))
    z = torch.abs(torch.from_numpy(x)[..., None] - m) / torch.from_numpy(sigma)[:, None, None]
    return (-torch.log(-tvit.log_sf_std_normal(z))).numpy()


def first_max_tree(nu: np.ndarray):
    """(max, first argmax) over the last axis as the kernel's tree does
    it: pairs (0, 1), (2, 3), (4, 5), then left to right; a pair keeps its
    left member unless the right one is strictly larger."""
    def pick(a, b):
        (ma, aa), (mb, ab) = a, b
        take = mb > ma
        return np.where(take, mb, ma), np.where(take, ab, aa)

    leaf = [(nu[..., s], np.full(nu.shape[:-1], s)) for s in range(nu.shape[-1])]
    if nu.shape[-1] == 6:
        return pick(pick(pick(leaf[0], leaf[1]), pick(leaf[2], leaf[3])),
                    pick(leaf[4], leaf[5]))
    return pick(pick(leaf[0], leaf[1]), leaf[2])


def replay(x, lengths, sigma, bnd, means, em=None):
    """The kernels' recursion on packed words, vectorised over the batch:
    returns (1-based int8 states [B, L], words [B, L], ties) where ties
    counts the (step, state) pairs decided by a tie."""
    B, L = x.shape
    S = len(means)
    log_diag, log_off, log_delta = tvit.transition_logs(S, 1e-6)
    f_diag, f_off = np.float32(log_diag), np.float32(log_off)
    em = emissions(x, sigma, means) if em is None else em
    n = np.maximum(np.minimum(lengths, L), 1)
    nu = np.zeros((B, S), np.float32)
    words = np.zeros((B, L), np.uint16)
    ties = 0
    for i in range(L):
        act = i < n
        flag = (bnd[:, i] != 0) | (i == 0)
        m, am = first_max_tree(nu)
        move = (m + f_off).astype(np.float32)
        stay = (nu + f_diag).astype(np.float32)
        s = np.arange(S)[None, :]
        took = (move[:, None] > stay) | ((move[:, None] == stay) & (am[:, None] < s))
        ties += int(((move[:, None] == stay) & act[:, None] & ~flag[:, None]).sum())
        ties += int((np.sort(nu, axis=1)[:, -1] == np.sort(nu, axis=1)[:, -2])[act].sum())
        mask = np.where(flag, (1 << S) - 1, (took << s).sum(axis=1))
        new = np.where(flag[:, None], log_delta[None, :],
                       np.maximum(stay, move[:, None])) + em[:, i]
        nu = np.where(act[:, None], new.astype(np.float32), nu)
        words[:, i] = np.where(act, am | (mask << 3), 0)
    _, y = first_max_tree(nu)
    out = np.zeros((B, L), np.int8)
    rows = np.arange(B)
    for b in range(B):
        out[b, n[b] - 1:] = y[b] + 1
    for i in range(L - 2, -1, -1):
        w = words[rows, np.minimum(i + 1, L - 1)].astype(np.int64)
        back = np.where((w >> (3 + y)) & 1, w & 7, y)
        y = np.where(i + 1 < n, back, y)
        out[:, i] = np.where(i < n - 1, y + 1, out[:, i])
    return out, words, ties


def plain(x, lengths, sigma, bnd, means):
    log_diag, log_off, log_delta = tvit.transition_logs(len(means), 1e-6)
    return tvit.viterbi_plain(torch.from_numpy(x), torch.from_numpy(lengths),
                              torch.from_numpy(sigma), torch.from_numpy(bnd),
                              means, log_delta, log_diag, log_off).numpy()


def case(name: str, S: int):
    """(x [B, L] f32, lengths [B] i32, sigma [B] f32, bnd [B, L] i8, means)."""
    rng = np.random.default_rng(11 + S)
    means = MEANS_ROUND if S == 6 else MEANS_I3
    B, L = 24, 70
    lengths = np.full(B, L, np.int32)
    bnd = np.zeros((B, L), np.int8)
    sigma = rng.uniform(0.15, 0.35, B).astype(np.float32)
    x = rng.normal(1.0, 0.4, (B, L)).astype(np.float32)
    if name == "random":
        bnd[:, [0, 25, 50]] = 1
    elif name == "ties":
        # midpoints of neighbouring means and the means themselves, all exact
        # in f32, and a sigma of 0.5: neighbouring states' emissions tie
        grid = np.concatenate([means, (means[1:] + means[:-1]) / 2]).astype(np.float32)
        x = grid[rng.integers(0, grid.shape[0], (B, L))]
        x[:, 20:40] = grid[-1]
        sigma[:] = 0.5
        bnd[:, [0, 35]] = 1
    elif name == "restart_every_position":
        bnd[:] = 1
    elif name == "lengths":
        lengths = rng.integers(1, L + 1, B).astype(np.int32)
        lengths[:3] = (1, 2, L)
        bnd[:, [0, 10, 40]] = 1
        bnd[np.arange(L)[None, :] >= lengths[:, None]] = 0
    elif name == "restarts_past_length":
        lengths[:] = rng.integers(5, L - 5, B)
        bnd[:, ::7] = 1
        bnd[:, L - 3] = 1
    elif name == "L1":
        x, bnd = x[:, :1].copy(), bnd[:, :1].copy()
        lengths[:] = 1
    return x, lengths, sigma, bnd, means


CASES = ["random", "ties", "restart_every_position", "lengths",
         "restarts_past_length", "L1"]


@pytest.mark.parametrize("S", [6, 3])
@pytest.mark.parametrize("name", CASES)
def test_packed_backpointers_replay_plain(name, S):
    """Packed as the kernels pack them (the argmax and the mask of states
    that took the move; at a restart, every state), the words decode to
    the plain version's states, in every case."""
    x, lengths, sigma, bnd, means = case(name, S)
    got, words, ties = replay(x, lengths, sigma, bnd, means)
    np.testing.assert_array_equal(got, plain(x, lengths, sigma, bnd, means))
    assert (words >> (3 + S) == 0).all() and ((words & 7) < S).all()
    if name == "ties":
        assert ties > 0
    if name == "restart_every_position":
        assert (words[:, 1:] >> 3 == (1 << S) - 1).all()


@pytest.mark.parametrize("name", ["random", "lengths"])
def test_replay_matches_interpreted_pallas(name):
    """The same replay against the reference's Pallas kernel, interpreted
    (cases whose restart flags lie inside the lengths: ROADMAP queue C)."""
    x, lengths, sigma, bnd, _ = case(name, 6)
    want = np.asarray(viterbi_pallas(x, lengths, sigma, MEANS, t=1e-6,
                                     boundaries=bnd, interpret=True))
    got, _, _ = replay(x, lengths, sigma, bnd, MEANS)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("S", [6, 3])
def test_first_max_tree_is_sequential_first_max(S):
    """The kernel's tree equals R's which.max (the first of the largest) on
    every pattern of S values in {0, 1, 2}."""
    pats = np.array(list(itertools.product([0.0, 1.0, 2.0], repeat=S)),
                    np.float32)
    m, am = first_max_tree(pats)
    np.testing.assert_array_equal(m, pats.max(axis=1))
    np.testing.assert_array_equal(am, pats.argmax(axis=1))
    seq_m, seq_a = pats[:, 0].copy(), np.zeros(pats.shape[0], int)
    for s in range(1, S):
        better = pats[:, s] > seq_m
        seq_m = np.where(better, pats[:, s], seq_m)
        seq_a = np.where(better, s, seq_a)
    np.testing.assert_array_equal(am, seq_a)


def ring_schedule(nchunk: int, ring: int, producers: int, seed: int):
    """A random interleaving of the latency block's agents under its
    mbarriers: producer warp p fills chunks p, p + P, ... (slot c % ring,
    after the consumer has emptied the slot's previous chunk); the consumer
    takes chunks in order once full.  Yields ("fill", c) and ("take", c)."""
    rng = np.random.default_rng(seed)
    nxt = list(range(producers))        # each producer's next chunk
    full = {}                           # slot -> chunk it holds, full
    taken = 0
    emptied = [-1] * ring               # last chunk consumed from each slot
    while taken < nchunk:
        moves = []
        for p in range(producers):
            c = nxt[p]
            if c < nchunk:
                r = c % ring
                if c // ring == 0 or emptied[r] == c - ring:
                    moves.append(("fill", p, c))
        if full.get(taken % ring) == taken:
            moves.append(("take", None, taken))
        assert moves, "the ring deadlocked"
        kind, p, c = moves[rng.integers(len(moves))]
        if kind == "fill":
            assert c % ring not in full, "a slot was refilled before it was taken"
            full[c % ring] = c
            nxt[p] += producers
        else:
            del full[c % ring]
            emptied[c % ring] = c
            taken += 1
        yield kind, c


@pytest.mark.parametrize("L,ring,producers", [(678, 8, 3), (70, 8, 3),
                                              (31, 8, 3), (6460, 8, 3),
                                              (200, 2, 3), (200, 1, 1)])
def test_emission_ring_in_order(L, ring, producers):
    """Chunks of 32 positions computed into the ring by the producers, in
    any order the mbarriers allow, and consumed in order, deliver every
    position's emissions and restart flag as one pass computes them."""
    rng = np.random.default_rng(L)
    x = rng.normal(1.0, 0.4, (1, L)).astype(np.float32)
    sigma = np.array([0.25], np.float32)
    bnd = (rng.random((1, L)) < 0.05).astype(np.int8)
    one_pass = emissions(x, sigma, MEANS)[0]
    flags = (bnd[0] != 0) | (np.arange(L) == 0)
    C = tvit.RING_CHUNK
    nchunk = -(-L // C)
    slots = np.zeros((ring, C, 7), np.float32)
    restarts = np.zeros(ring, bool)     # a slot's chunk restarts somewhere
    seen_em, seen_fl = [], []
    for kind, c in ring_schedule(nchunk, ring, producers, seed=L + ring):
        i = c * C + np.arange(C)
        ok = i < L
        if kind == "fill":
            chunk = emissions(x[:, np.minimum(i, L - 1)], sigma, MEANS)[0]
            slots[c % ring, :, :6] = chunk
            slots[c % ring, :, 6] = np.where(ok, flags[np.minimum(i, L - 1)], 0)
            restarts[c % ring] = (slots[c % ring, ok, 6] != 0).any()
        else:
            # a chunk flagged as restarting nowhere is run without selects:
            # its flags are all 0
            fl = slots[c % ring, ok, 6] != 0
            assert restarts[c % ring] or not fl.any()
            seen_em.append(slots[c % ring, ok, :6].copy())
            seen_fl.append(fl)
    np.testing.assert_array_equal(np.concatenate(seen_em), one_pass)
    np.testing.assert_array_equal(np.concatenate(seen_fl), flags)


@pytest.mark.parametrize("B", [1, 160, 208, 425_984])
@pytest.mark.parametrize("L", [1, 678, 920, 6460, 20_000])
@pytest.mark.parametrize("S", [6, 3])
def test_plan_fits_the_h100(B, L, S):
    """Every plan for the engine's shapes and beyond fits an H100's shared
    memory and SMs, in the regime it picks and in the other: the latency
    regime keeps the backpointers in shared memory up to 20,000 positions;
    the throughput regime's persistent blocks make no more rounds over the
    batch than a full card would."""
    plan = tvit.viterbi_plan(B, L, S, H100_SMEM, H100_SMS)
    assert plan.regime == ("latency" if B <= 4 * H100_SMS else "throughput")
    for regime in ("latency", "throughput"):
        p = tvit.viterbi_plan(B, L, S, H100_SMEM, H100_SMS, regime=regime)
        assert p.smem_bytes <= H100_SMEM and p.threads % 32 == 0
        if regime == "latency":
            assert p.blocks == B and p.bp_shared and p.threads >= 64
            assert p.smem_bytes == tvit.latency_smem_bytes(S, L, p.ring, p.threads, True)
            assert 2 * L + L <= p.smem_bytes
        else:
            assert p.smem_bytes == 0 and p.threads == 64
            assert 1 <= p.blocks <= H100_SMS * 24
            full = H100_SMS * 24 * 64
            assert -(-B // (p.blocks * p.threads)) == max(1, -(-B // full))


def test_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError):
        tvit.viterbi_plan(8, 100, 4, H100_SMEM, H100_SMS)        # S
    with pytest.raises(ValueError):
        tvit.viterbi_plan(8, 0, 6, H100_SMEM, H100_SMS)          # L
    with pytest.raises(ValueError):
        tvit.viterbi_plan(8, 100, 6, 4_096, H100_SMS)            # the ring
    with pytest.raises(ValueError):
        tvit.viterbi_plan(8, 100, 6, H100_SMEM, H100_SMS, regime="warp")
    # a sequence whose backpointers do not fit beside the ring keeps them
    # in device memory, the same packed words
    big = tvit.viterbi_plan(8, 100_000, 6, H100_SMEM, H100_SMS)
    assert big.regime == "latency" and not big.bp_shared
    assert big.smem_bytes == tvit.latency_smem_bytes(6, 100_000, big.ring, big.threads,
                                                     False)


def test_packed_states_from_the_kernels_layout(monkeypatch):
    """The throughput regime returns its [L, B] states as a transposed view;
    viterbi_packed reads each gene's state from its bin and position there,
    and gives the states it gives from [B, L] states."""
    from infercnv_tpu_torch.ops import viterbi_pack as tpack
    from torch_port_util import gene_orders

    _, tgo = gene_orders([90, 60, 41, 30, 1, 12])
    layout = tpack.get_layout(tgo)
    rng = np.random.default_rng(4)
    resid = torch.from_numpy(rng.normal(1.0, 0.3, (9, tgo.num_genes)).astype(np.float32))
    sig = torch.full((9,), 0.25)
    want = tpack.viterbi_packed(resid, layout, MEANS, sig, 1e-6)
    plain = tvit.viterbi

    def transposed(*a, **k):
        return plain(*a, **k).t().contiguous().t()
    monkeypatch.setattr(tpack, "viterbi", transposed)
    got = tpack.viterbi_packed(resid, layout, MEANS, sig, 1e-6)
    assert got.stride() == (1, 9)
    assert torch.equal(got, want)
