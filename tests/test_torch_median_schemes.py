"""The launch plan and the row walk of the median kernels (csrc/median.cu),
replayed in numpy on the CPU (the kernels themselves run only on the card).

A row reaches the select as 16-byte slots: its head values up to the first
16-byte boundary, whole slots (the first ones staged in shared memory by
bulk copies in chunks, the rest read from device memory), and its last
values.  The select's first pass counts each chunk as it lands, then the
rest; a thread counts its 4 values with one atomic where their digits agree,
and a warp whose lanes agree adds its total in one (count_digits of
csrc/radix_select.cuh).  The replays hold the plan to the kernel's layout
and the card's limits, the walk to covering every value once, and the
medians bit for bit to np.median, the port's plain median and the
interpreted Pallas median of the JAX package."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infercnv_tpu.ops.median import row_median_pallas
from infercnv_tpu_torch.ops import median as tmed

from test_torch_kernel_schemes import SELECT_ROWS, f2key, key2f
from torch_port_util import median_cases

CSRC = Path(tmed.__file__).resolve().parents[1] / "csrc"
#: the H100's opt-in shared memory a block and SMs
H100_OPTIN, H100_SMS = 232_448, 132
#: values the row buffer holds where a 60,000-gene row is split (55,996)
S = tmed.median_plan(60_000, 60_000, H100_OPTIN, H100_SMS).capacity
PLAN_WIDTHS = (1, 2, 7, 1000, 1001, 8447, 8448, S - 1, S, S + 1, 60_000,
               200_000)


def test_plan_constants_match_the_kernel():
    """The plan's shared-memory layout is the kernel's: the select,
    kMaxChunks mbarriers, then the row buffer."""
    med = (CSRC / "median.cu").read_text()
    sel = (CSRC / "radix_select.cuh").read_text()
    assert int(re.search(r"constexpr int kMaxChunks = (\d+);", med)[1]) \
        == tmed._MAX_CHUNKS
    assert int(re.search(r"constexpr int kMedianMaxThreads = (\d+);", med)[1]) \
        == tmed._THREADS_ALONE
    assert int(re.search(r"constexpr int kSelectBins = (\d+);", sel)[1]) == 2048
    assert tmed._HEAD_BYTES % 16 == 0


@pytest.mark.parametrize("G", PLAN_WIDTHS)
@pytest.mark.parametrize("pad", [0, 1, 3, 4, 5])
def test_plan(G, pad):
    ld = G + pad
    p = tmed.median_plan(G, ld, H100_OPTIN, H100_SMS)
    assert p.staged + p.tail == G and 0 <= p.staged <= p.capacity <= G
    # 16-byte copies from 16-byte offsets of a 16-byte-aligned buffer
    assert p.capacity % 4 == 0 and p.chunk % 4 == 0
    assert tmed._HEAD_BYTES % 16 == 0
    assert p.chunks <= tmed._MAX_CHUNKS and p.chunk <= tmed._CHUNK_VALUES
    if p.capacity:
        assert p.chunks * p.chunk >= p.capacity > (p.chunks - 1) * p.chunk
    else:
        assert p.chunks == p.chunk == 0
    # the card's limits
    assert p.smem_bytes == tmed._HEAD_BYTES + 4 * p.capacity
    assert p.smem_bytes <= H100_OPTIN
    assert p.blocks_per_sm >= 1 and p.blocks == H100_SMS * p.blocks_per_sm
    assert p.blocks_per_sm * (p.smem_bytes + 1024) <= H100_OPTIN + 1024
    assert p.threads % 32 == 0 and p.threads <= 1024
    assert p.blocks_per_sm * p.threads <= 2048
    assert p.blocks_per_sm * p.threads * 64 <= 65536
    # 256 threads a block where two blocks fit an SM, else one of 1024
    assert p.threads == (256 if 2 * (p.smem_bytes + 1024) <= H100_OPTIN + 1024
                         else 1024)
    # every row, at each offset of its first 16-byte boundary, stages at
    # least `staged` values, and a whole row wherever the buffer holds it
    heads = [0] if ld % 4 == 0 else [0, 1, 2, 3]
    for h in heads:
        per_row = min(p.capacity, (G - min(h, G)) // 4 * 4)
        assert per_row >= p.staged
        if G // 4 * 4 <= p.capacity:
            assert G - per_row <= 3 + min(h, G)


def test_plan_of_the_paths():
    """The two shapes the engine's paths give the kernels."""
    p = tmed.median_plan(8448, 8448, H100_OPTIN, H100_SMS)   # coordinates
    assert (p.threads, p.blocks_per_sm, p.tail) == (256, 4, 0)
    p = tmed.median_plan(60_000, 60_000, H100_OPTIN, H100_SMS)   # wide genome
    assert (p.threads, p.blocks_per_sm) == (1024, 1)
    assert p.tail == 60_000 - S and p.tail / 60_000 < 0.07


def test_plan_refuses():
    for G, ld in ((0, 0), (10, 9)):
        with pytest.raises(ValueError):
            tmed.median_plan(G, ld, H100_OPTIN, H100_SMS)
    with pytest.raises(ValueError):         # no room beside the select
        tmed.median_plan(10, 10, tmed._HEAD_BYTES, H100_SMS)


# ---- count_digits: a thread's merge and the warp vote -------------------

def count_digits(hist, d, vote: bool) -> int:
    """count_digits<4, kVote> over warps: d [lanes (a multiple of 32), 4]
    digits, -1 where a value is not counted.  Adds to hist; returns the
    number of atomics issued."""
    d = d.reshape(-1, 32, 4)
    valid = d >= 0
    atomics = 0
    if not vote:
        same = (d == d[..., :1]).all(-1)
        whole = same & (d[..., 0] >= 0)
        np.add.at(hist, d[..., 0][whole], 4)
        split = valid & ~same[..., None]
        np.add.at(hist, d[split], 1)
        return int(whole.sum() + split.sum())
    n = valid.sum(-1)
    dmax = np.where(valid, d, -1).max(-1)
    dmin = np.where(valid, d, 1 << 30).min(-1)
    mixed = (n > 0) & (dmax != dmin)
    mine = np.where(mixed, -2, dmax)
    top = mine.max(-1)
    uniform = (top >= 0) & ((mine == top[:, None]) | (mine == -1)).all(-1)
    np.add.at(hist, top[uniform], n[uniform].sum(-1))
    atomics += int(uniform.sum())
    lane = ~uniform[:, None] & ~mixed & (n > 0)
    np.add.at(hist, mine[lane], n[lane])
    atomics += int(lane.sum())
    each = ~uniform[:, None, None] & mixed[..., None] & valid
    np.add.at(hist, d[each], 1)
    return atomics + int(each.sum())


def _lanes(kind: str, rng) -> np.ndarray:
    """Digits of 32 lanes x 4 values of one warp step."""
    if kind == "uniform":
        d = np.full((32, 4), 1234)
    elif kind == "uniform_unaligned":
        # a row's head (lane 0: 1 value) and last values (lane 31: 2), and
        # lanes past the row's end
        d = np.full((32, 4), 77)
        d[0, :3] = -1
        d[31, 2:] = -1
        d[20:31] = -1
    elif kind == "uniform_sparse":         # a later pass: few values match
        d = np.where(rng.random((32, 4)) < 0.3, 5, -1)
    elif kind == "two_digits":             # a digit boundary inside the warp
        d = np.where(np.arange(128).reshape(32, 4) < 61, 8, 9)
    elif kind == "empty":
        d = np.full((32, 4), -1)
    else:                                  # random digits, random masks
        d = np.where(rng.random((32, 4)) < 0.8, rng.integers(0, 2048, (32, 4)), -1)
    return d


@pytest.mark.parametrize("kind", ["uniform", "uniform_unaligned", "uniform_sparse",
                                  "two_digits", "empty", "random"])
@pytest.mark.parametrize("vote", [True, False])
def test_count_digits_is_counting_value_by_value(kind, vote):
    rng = np.random.default_rng(5)
    d = np.concatenate([_lanes(kind, rng) for _ in range(3)])
    hist = np.zeros(2048, np.int64)
    atomics = count_digits(hist, d, vote)
    want = np.bincount(d[d >= 0], minlength=2048)
    np.testing.assert_array_equal(hist, want)
    if vote and kind.startswith("uniform"):
        assert atomics == 3                # one a warp
    if vote and kind == "two_digits":
        assert atomics == 3 * 35           # 31 lanes, and 4 of the mixed one


# ---- the row walk and the select ----------------------------------------

SHIFTS, BITS = (21, 10, 0), (11, 11, 10)


class RowWalk:
    """MedRow of csrc/median.cu: a row whose start lies `mis` values past a
    16-byte boundary, with a row buffer of `capacity` values.  idx[q] holds
    the genes of slot q (-1 for none)."""

    def __init__(self, G: int, mis: int, capacity: int):
        h = min((4 - mis) & 3, G)
        nf = (G - h) // 4
        self.ns = min(capacity // 4, nf)
        self.nslots = nf + 2
        idx = np.full((nf + 2, 4), -1, np.int64)
        idx[:nf] = h + np.arange(4 * nf).reshape(nf, 4)
        idx[nf, :h] = np.arange(h)
        idx[nf + 1, :G - h - 4 * nf] = np.arange(h + 4 * nf, G)
        self.h, self.idx = h, idx

    def chunks(self, chunk: int, n: int):
        """Slot ranges of the copies, in landing order."""
        cq = chunk // 4
        return [(min(k * cq, self.ns), min((k + 1) * cq, self.ns)) for k in range(n)]


def walk_digits(keys, walk: RowWalk, q0: int, q1: int, T: int, digit):
    """The digits of slots [q0, q1) as the kernel's trips of T threads
    read them, a trip's slots padded to T (-1: no value, or one the digit
    function does not count)."""
    idx = walk.idx[q0:q1]
    d = np.where(idx >= 0, digit(keys[np.maximum(idx, 0)]), -1)
    pad = -(q1 - q0) % T
    return np.concatenate([d, np.full((pad, 4), -1, np.int64)])


def replay_kernel_median(x: np.ndarray, mis: int, plan, T: int) -> np.float32:
    """block_row_median as median_rows_kernel runs it: the walk covers every
    value once and the copies the staged slots once, each from a 16-byte
    boundary; the first pass counts the chunks in landing order, then the
    values read from device memory; passes 2 and 3 step over every slot."""
    G = x.shape[0]
    walk = RowWalk(G, mis, plan.capacity)
    seen = walk.idx[walk.idx >= 0]
    np.testing.assert_array_equal(np.sort(seen), np.arange(G))
    chunks = walk.chunks(plan.chunk, plan.chunks)
    covered = [q for a, b in chunks for q in range(a, b)]
    assert covered == list(range(walk.ns))
    for a, b in chunks:
        assert b == a or (mis + walk.h + 4 * a) % 4 == 0   # a 16-byte offset
    keys = f2key(x).astype(np.int64)
    hist = np.zeros(2048, np.int64)
    top = lambda k: k >> SHIFTS[0]                       # noqa: E731
    for a, b in chunks + [(walk.ns, walk.nslots)]:
        count_digits(hist, walk_digits(keys, walk, a, b, T, top), vote=True)
    k = G // 2
    prefix, krem, below = 0, k, 0
    for p in range(3):
        shift, bits = SHIFTS[p], BITS[p]
        if p > 0:
            hmask = (0xFFFFFFFF << (shift + bits)) & 0xFFFFFFFF
            dm = (1 << bits) - 1
            match = lambda kk: np.where(((kk ^ prefix) & hmask) == 0,  # noqa: E731
                                        (kk >> shift) & dm, -1)
            hist = np.zeros(1 << bits, np.int64)
            count_digits(hist, walk_digits(keys, walk, 0, walk.nslots, T, match),
                         vote=True)
            if p == 2:
                low = keys[(((keys ^ prefix) & hmask) != 0) & (keys < prefix)]
                below = int(low.max()) if low.size else 0
        cum = np.cumsum(hist)
        bin_ = int(np.searchsorted(cum, krem, side="right"))
        krem -= int(cum[bin_] - hist[bin_])
        prefix |= bin_ << shift
    v2 = prefix
    if G % 2:
        return key2f(v2)
    v1 = v2
    if krem == 0:
        nz = np.nonzero(hist[:v2 & 1023])[0]
        v1 = (v2 & ~1023) | int(nz[-1]) if nz.size else below
    return np.float32((key2f(v1) + key2f(v2)) * np.float32(0.5))


def _same_median(got, want) -> bool:
    """Bit-equal, or both zero (numpy's partition leaves -0 and +0
    unordered; the keys put -0 first, as the reference's do)."""
    got, want = np.float32(got), np.float32(want)
    if want == 0:
        return got == 0
    return got.view(np.uint32) == want.view(np.uint32)


#: a small buffer (64 values), so that rows of a few hundred values are
#: split as a 60,000-gene row is on the card: opt-in bytes
SPLIT_OPTIN = tmed._HEAD_BYTES + 4 * 64


@pytest.mark.parametrize("name", sorted(SELECT_ROWS))
def test_kernel_walk_is_numpy_median(name):
    """Every select row, at each offset of its start, through the card's
    plan and through a plan that splits it (64 values staged, two chunks
    of 32, the rest from device memory), with 64 threads a block (two
    warps, several trips a pass)."""
    x = SELECT_ROWS[name]
    G = x.shape[0]
    want = np.median(x)
    plain = tmed.row_median_plain(torch.from_numpy(x[None, :])).numpy()[0]
    plans = [tmed.median_plan(G, G, H100_OPTIN, H100_SMS),
             tmed.median_plan(G, G, SPLIT_OPTIN, 1)]
    plans.append(tmed.MedianPlan(**{**plans[1].__dict__, "chunk": 32, "chunks": 2}))
    for plan in plans:
        for mis in range(4):
            got = replay_kernel_median(x, mis, plan, T=64)
            assert _same_median(got, want), (plan, mis, got, want)
            assert np.float32(got).view(np.uint32) == plain.view(np.uint32)


def _smooth_rows(G: int, n: int, seed: int) -> np.ndarray:
    """Rows shaped like a smooth output: neighbours differ a little, so a
    warp's values share their top digits."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.normal(0, 2e-3, (n, G)), axis=1)
    return (walk + rng.normal(0, 0.05, (n, 1))).astype(np.float32)


@pytest.mark.parametrize("G", [8447, 8448, S - 1, S, S + 1, 60_000])
def test_kernel_walk_at_path_widths(G):
    """Smooth-like rows of the paths' widths and the split point, through
    the card's plan and threads, aligned and not."""
    plan = tmed.median_plan(G, G, H100_OPTIN, H100_SMS)
    x = _smooth_rows(G, 2, G)
    x[1, : G // 3] = x[1, G // 3]            # one long run of equal values
    for row in x:
        for mis in (0, 3):
            got = replay_kernel_median(row, mis, plan, T=plan.threads)
            assert _same_median(got, np.median(row))


def test_kernel_walk_matches_pallas():
    """The replay against the reference's interpreted Pallas median on the
    shared median cases (odd and even widths, ties, +-inf, -0) and on the
    select rows (grouped by width), through a splitting plan.  Not the rows
    of subnormals: XLA on the CPU flushes them to zero (the replay holds
    them to np.median above)."""
    groups = dict(median_cases())
    by_width = {}
    for name in sorted(SELECT_ROWS):
        if name.startswith("subnormals"):
            continue
        by_width.setdefault(SELECT_ROWS[name].shape[0], []).append(SELECT_ROWS[name])
    for G, rows in by_width.items():
        groups[f"select_{G}"] = np.stack(rows)
    for name, x in groups.items():
        G = x.shape[1]
        plan = tmed.median_plan(G, G, SPLIT_OPTIN, 1)
        want = np.asarray(row_median_pallas(jnp.asarray(x), interpret=True))
        got = np.array([replay_kernel_median(r, 1, plan, T=64) for r in x],
                       np.float32)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.astype(np.float32).view(np.uint32),
                                      err_msg=name)
