#!/usr/bin/env python3
"""1M-cell single-card streaming run of the bare engine, a port of
benchmarks/scale1m.py: counts are drawn on the card a chunk at a time and
consumed at once (a 1M x 8448 float32 matrix is ~34 GB and never exists),
with the CNV-state summaries reduced on the card.

    python3 benchmarks/torch_scale1m.py [cells|subclusters] [--cells N]
        [--chunk N] [--device cpu]

bench.py's genome (8448 genes on 22 chromosomes, start = stop = the gene's
index) and i6 parameters, gene means gamma(2, 30) from numpy seed 0; every
odd chunk carries a 0.5x loss of chr2.  A first chunk without the loss
gives the norm factor (the median library size, kernel 7) and the pooled
reference statistics of its first 4,096 cells.  Then, timed with the
counts' draws (torch.poisson from a seeded generator on the card):

  subclusters  the default analysis configuration: sums of 16 round-robin
               subclusters accumulated over every chunk (the chunks with
               the loss add to subclusters 8-15), one group-mean Viterbi at
               the end; gated: the loss called in subclusters 8-15 above
               0.7 of their chr2 genes, subclusters 0-7 neutral above 0.9
  cells        the per-cell Viterbi on every chunk (kernel 2's throughput
               regime); the losses and gains called summed on the card, no
               host synchronisation between chunks; gated: the loss's share
               of all calls at least 0.7 of its expected 0.5 * |chr2| / G

The reference only logs its fractions; here a gate that fails exits 1.
Prints one JSON line: seconds, cells/s, peak host RSS, the card's peak
memory, the summaries and the gates.  Runs on the CUDA card unless given
--device cpu (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from infercnv_tpu_torch.core.genome import GeneOrder  # noqa: E402
from infercnv_tpu_torch.device import resolve_device  # noqa: E402
from infercnv_tpu_torch.models.hmm import HMMParams  # noqa: E402
from infercnv_tpu_torch.ops.median import row_median  # noqa: E402
from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig  # noqa: E402

CELLS = 1_048_576
CHUNK = 8192
GENES = 8448
N_CHR = 22
N_SUB = 16
#: cells of the first chunk that give the reference statistics (scale1m.py:61)
REF_CELLS = 4096
#: i6 emission parameters of bench.py (scale1m.py:35-37)
MEANS = (0.135, 0.631, 1.0, 1.346, 1.702, 2.237)
SDS = (0.221, 0.252, 0.211, 0.288, 0.341, 0.457)
NEUTRAL = 3
#: the gates, chip_smoke.called's thresholds
CALLED = 0.7
NEUTRAL_SHARE = 0.9


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def peak_rss_gb() -> float:
    """The process's peak resident set in GB: getrusage's ru_maxrss (KiB),
    where scale1m_run.py:89-94 reads VmHWM, which the card's machine's
    /proc does not show."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def card_peak_gb(dev: torch.device):
    """The card's peak allocated memory in GB, or None on the CPU."""
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def chromosome_sizes(G: int = GENES, n_chr: int = N_CHR) -> np.ndarray:
    """Genes a chromosome: falling linearly from 800 to 120 and scaled to G,
    the remainder to chr1 (scale1m.py:24-26, bayes100k.py:36-38)."""
    sizes = np.linspace(800, 120, n_chr).astype(int)
    sizes = (sizes / sizes.sum() * G).astype(int)
    sizes[0] += G - sizes.sum()
    return sizes


def gene_order(sizes, spacing: int = 1, length: int = 0) -> GeneOrder:
    """Genes g0.. on chr1.. of `sizes`, gene i at i * spacing to
    i * spacing + length (scale1m.py:27-32; bayes100k.py:39-44 and
    scale100k_run.py:40-45 with spacing 1000, length 500)."""
    G = int(np.sum(sizes))
    return GeneOrder(
        names=tuple(f"g{i}" for i in range(G)),
        chr_names=tuple(f"chr{i+1}" for i in range(len(sizes))),
        chr_ids=np.repeat(np.arange(len(sizes)), sizes).astype(np.int32),
        start=np.arange(G) * spacing, stop=np.arange(G) * spacing + length,
    )


def build_genome(G: int = GENES, n_chr: int = N_CHR):
    """bench.py's genome: start = stop = the gene's index (scale1m.py:24-34).
    Returns (GeneOrder, sizes)."""
    sizes = chromosome_sizes(G, n_chr)
    return gene_order(sizes), sizes


def bench_hmm() -> HMMParams:
    return HMMParams(means=np.array(MEANS), sds=np.array(SDS), t=1e-6)


def planted(G: int, sizes, seed: int = 0):
    """Gene means gamma(2, 30) from numpy seed `seed` and the chr2 loss's
    factor row (0.5 on chr2, 1 elsewhere), float32 (scale1m.py:41-45)."""
    rng = np.random.default_rng(seed)
    gm = rng.gamma(2.0, 30.0, G).astype(np.float32)
    loss = np.ones(G, np.float32)
    loss[sizes[0]:sizes[0] + sizes[1]] = 0.5
    return gm, loss


def card_chunks(gm, loss, chunk: int, n_chunks: int, has_loss, dev,
                seed: int = 0):
    """Poisson counts drawn on `dev` from a generator seeded with `seed`,
    float32 [chunk, G] a chunk: first one without the loss (the reference
    chunk), then chunks 0 .. n_chunks - 1, with the loss where has_loss(i)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    gm_t = torch.as_tensor(gm, device=dev)
    lam = {False: gm_t[None, :].expand(chunk, -1).contiguous(),
           True: (gm_t * torch.as_tensor(loss, device=dev))[None, :]
           .expand(chunk, -1).contiguous()}
    yield torch.poisson(lam[False], generator=gen)
    for i in range(n_chunks):
        yield torch.poisson(lam[bool(has_loss(i))], generator=gen)


def norm_factor(libs: torch.Tensor) -> float:
    """The median library size, by the exact row median (kernel 7 on the
    card; scale1m.py:55-59)."""
    return float(row_median(libs.to(torch.float32)[None, :])[0])


def subcluster_onehots(chunk: int, dev, n_sub: int = N_SUB):
    """[n_sub, chunk] memberships of round-robin subclusters, and the same
    rolled by n_sub / 2 for the chunks with the loss (scale1m.py:78-85)."""
    labels = np.arange(chunk) % n_sub
    onehot = np.zeros((n_sub, chunk), np.float32)
    onehot[labels, np.arange(chunk)] = 1.0
    rolled = np.roll(onehot, n_sub // 2, axis=0)
    return torch.as_tensor(onehot, device=dev), torch.as_tensor(rolled, device=dev)


def stream_cells(engine, chunks, nf: float, ml, mr, log_every: int = 16):
    """full_chunk on every chunk; the states below and above neutral summed
    on the card (int64: exact; scale1m.py:105-117).  Synchronises only
    every log_every chunks to log the rate.  Returns ([n_loss, n_gain] on
    the card, cells streamed)."""
    dev = engine.device
    acc = torch.zeros(2, dtype=torch.int64, device=dev)
    n_cells = 0
    t0 = time.perf_counter()
    for i, counts in enumerate(chunks):
        _final, states = engine.full_chunk(counts, nf, ml, mr)
        acc += torch.stack([(states < NEUTRAL).sum(), (states > NEUTRAL).sum()])
        n_cells += counts.shape[0]
        if i % log_every == log_every - 1:
            sync(dev)
            log(f"chunk {i + 1}  ({n_cells / (time.perf_counter() - t0):.0f} cells/s "
                f"incl. the draws)")
    return acc, n_cells


def stream_subclusters(engine, chunks, nf: float, ml, mr, chunk: int, has_loss,
                       n_sub: int = N_SUB, log_every: int = 32):
    """subcluster_chunk on every chunk, the subcluster sums accumulated on
    the card, then one Viterbi on the group means (scale1m.py:74-94).
    Returns (states [n_sub, G], group sums, group counts, cells streamed)."""
    dev = engine.device
    oh, oh_loss = subcluster_onehots(chunk, dev, n_sub)
    acc = None
    n_cells = 0
    t0 = time.perf_counter()
    for i, counts in enumerate(chunks):
        _resid, gs, gc = engine.subcluster_chunk(
            counts, nf, ml, mr, None, oh_loss if has_loss(i) else oh, acc=acc)
        acc = (gs, gc)
        n_cells += counts.shape[0]
        if i % log_every == log_every - 1:
            sync(dev)
            log(f"chunk {i + 1}  ({n_cells / (time.perf_counter() - t0):.0f} cells/s "
                f"incl. the draws)")
    states = engine.viterbi_group_means(acc[0] / acc[1][:, None])
    return states, acc[0], acc[1], n_cells


def cells_gates(n_loss: int, n_gain: int, n_cells: int, sizes) -> dict:
    G = int(np.sum(sizes))
    expected = 0.5 * sizes[1] / G   # half the chunks carry the chr2 loss
    loss = n_loss / (n_cells * G)
    return {"loss_fraction": loss, "expected_loss_fraction": expected,
            "gain_fraction": n_gain / (n_cells * G),
            "loss_called": bool(loss >= CALLED * expected)}


def subcluster_gates(states, sizes, n_sub: int = N_SUB) -> dict:
    st = states.cpu().numpy() if torch.is_tensor(states) else np.asarray(states)
    loss = float((st[n_sub // 2:, sizes[0]:sizes[0] + sizes[1]] < NEUTRAL).mean())
    neutral = float((st[:n_sub // 2] == NEUTRAL).mean())
    return {"loss_called_8_15": loss, "neutral_0_7": neutral,
            "loss_called": bool(loss > CALLED), "neutral": bool(neutral > NEUTRAL_SHARE)}


def run_stream(engine, sizes, chunks, mode: str, chunk: int, has_loss) -> dict:
    """The program after the engine: the first chunk of `chunks` gives the
    norm factor and the reference statistics, the rest stream in `mode`.
    Returns the summaries, the seconds of the stream (draws included) and
    the gates."""
    dev = engine.device
    chunks = iter(chunks)
    ref_counts = next(chunks)
    nf = norm_factor(ref_counts.sum(dim=1))
    log(f"norm factor {nf:.0f}")
    ml, mr, _ = engine.ref_stats(ref_counts[:REF_CELLS], nf)
    sync(dev)
    del ref_counts
    t0 = time.perf_counter()
    if mode == "subclusters":
        states, gs, gc, n_cells = stream_subclusters(engine, chunks, nf, ml, mr,
                                                     chunk, has_loss)
        states = states.cpu()
        seconds = time.perf_counter() - t0
        out = dict(states=states, group_sums=gs.cpu(), group_counts=gc.cpu(),
                   gates=subcluster_gates(states, sizes))
    elif mode == "cells":
        acc, n_cells = stream_cells(engine, chunks, nf, ml, mr)
        n_loss, n_gain = (int(v) for v in acc.cpu())
        seconds = time.perf_counter() - t0
        out = dict(n_loss=n_loss, n_gain=n_gain,
                   gates=cells_gates(n_loss, n_gain, n_cells, sizes))
    else:
        raise ValueError(f"mode must be 'cells' or 'subclusters', not {mode!r}")
    out.update(mode=mode, cells=n_cells, norm_factor=nf, seconds=seconds,
               cells_per_sec=n_cells / seconds)
    return out


def passed(gates: dict) -> bool:
    return all(v for v in gates.values() if isinstance(v, bool))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="cells", choices=("cells", "subclusters"))
    ap.add_argument("--cells", type=int, default=CELLS)
    ap.add_argument("--chunk", type=int, default=CHUNK)
    ap.add_argument("--device", default=None, help="the CUDA card by default; 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t_all = time.perf_counter()
    go, sizes = build_genome()
    engine = CnvEngine(go, bench_hmm(), EngineConfig(), device=dev)
    n_chunks = args.cells // args.chunk
    log(f"engine ready; streaming {n_chunks * args.chunk} cells in {n_chunks} chunks "
        f"on {device_name(dev)}")
    gm, loss = planted(go.num_genes, sizes)

    def has_loss(i):
        return i % 2 == 1

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res = run_stream(engine, sizes,
                     card_chunks(gm, loss, args.chunk, n_chunks, has_loss, dev),
                     args.mode, args.chunk, has_loss)
    log(f"{res['cells']} cells -> {args.mode} CNV calls in {res['seconds']:.1f}s "
        f"({res['cells_per_sec']:.0f} cells/s, incl. the draws on the card)")
    summary = {k: v for k, v in res.items()
               if k not in ("states", "group_sums", "group_counts")}
    print(json.dumps({
        "metric": f"engine_1m_{args.mode}_cells_per_sec", "value": res["cells_per_sec"],
        "unit": "cells/s", **summary, "chunk": args.chunk, "genes": go.num_genes,
        "wall_s": time.perf_counter() - t_all, "peak_host_rss_gb": peak_rss_gb(),
        "peak_card_gb": card_peak_gb(dev), "device": device_name(dev)}), flush=True)
    return 0 if passed(res["gates"]) else 1


if __name__ == "__main__":
    sys.exit(main())
