#!/usr/bin/env python3
"""Bare-engine 100k-cell run with the counts staged on the card first, a
port of benchmarks/scale100k.py: measures the compute path alone (the
product-level run is benchmarks/torch_scale100k_run.py).

    python3 benchmarks/torch_scale100k.py [--cells N] [--chunk N] [--device cpu]

benchmarks/torch_scale1m.py's genome, i6 parameters and gene means; the
counts of cells // chunk chunks (12 of 8192 for the reference's 102,400:
98,304 cells) are drawn on the card and kept there, the second half with
the 0.5x loss of chr2.  Timed from there: the norm factor (the median
library size of every staged cell, kernel 7), the pooled reference
statistics of the first chunk's first 4,096 cells, then full_chunk (the
per-cell Viterbi, kernel 2's throughput regime) on every chunk with the
losses and gains called summed on the card.  Gated, where the reference
only logs: the loss's share of all calls at least 0.7 of its expected
0.5 * |chr2| / G; a gate that fails exits 1.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_scale1m as s1m  # noqa: E402

from infercnv_tpu_torch.device import resolve_device  # noqa: E402
from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig  # noqa: E402

CELLS = 102_400
CHUNK = 8192


def stage(gm, loss, chunk: int, n_chunks: int, dev, seed: int = 0) -> list:
    """The n_chunks count chunks on the card, the second half with the loss
    (scale100k.py:37-45); the draws of torch_scale1m.card_chunks without its
    reference chunk."""
    chunks = s1m.card_chunks(gm, loss, chunk, n_chunks, lambda i: i >= n_chunks // 2,
                             dev, seed)
    next(chunks)
    return list(chunks)


def run_staged(engine, sizes, staged: list) -> dict:
    """From the staged chunks to the summed calls (scale100k.py:47-63):
    returns the summaries, the seconds (norm factor, ref_stats and stream)
    and the gates."""
    dev = engine.device
    t0 = time.perf_counter()
    nf = s1m.norm_factor(torch.cat([c.sum(dim=1) for c in staged]))
    s1m.log(f"norm factor {nf:.0f}")
    ml, mr, _ = engine.ref_stats(staged[0][:s1m.REF_CELLS], nf)
    s1m.sync(dev)
    t_stats = time.perf_counter() - t0
    acc, n_cells = s1m.stream_cells(engine, staged, nf, ml, mr)
    n_loss, n_gain = (int(v) for v in acc.cpu())
    seconds = time.perf_counter() - t0
    return dict(cells=n_cells, norm_factor=nf, n_loss=n_loss, n_gain=n_gain,
                ref_stats_s=t_stats, stream_s=seconds - t_stats, seconds=seconds,
                cells_per_sec=n_cells / seconds,
                gates=s1m.cells_gates(n_loss, n_gain, n_cells, sizes))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=CELLS)
    ap.add_argument("--chunk", type=int, default=CHUNK)
    ap.add_argument("--device", default=None, help="the CUDA card by default; 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t_all = time.perf_counter()
    go, sizes = s1m.build_genome()
    engine = CnvEngine(go, s1m.bench_hmm(), EngineConfig(), device=dev)
    s1m.log(f"engine built on {s1m.device_name(dev)}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gm, loss = s1m.planted(go.num_genes, sizes)
    n_chunks = args.cells // args.chunk
    t0 = time.perf_counter()
    staged = stage(gm, loss, args.chunk, n_chunks, dev)
    s1m.sync(dev)
    stage_s = time.perf_counter() - t0
    s1m.log(f"staged {n_chunks} chunks in {stage_s:.1f}s")
    res = run_staged(engine, sizes, staged)
    s1m.log(f"wall-clock to CNV calls at {res['cells']} cells: {res['seconds']:.1f}s "
            f"({res['cells_per_sec']:.0f} cells/s)")
    print(json.dumps({
        "metric": "engine_100k_staged_cells_per_sec", "value": res["cells_per_sec"],
        "unit": "cells/s", **res, "stage_s": stage_s, "chunk": args.chunk,
        "genes": go.num_genes, "wall_s": time.perf_counter() - t_all,
        "peak_host_rss_gb": s1m.peak_rss_gb(), "peak_card_gb": s1m.card_peak_gb(dev),
        "device": s1m.device_name(dev)}), flush=True)
    return 0 if s1m.passed(res["gates"]) else 1


if __name__ == "__main__":
    sys.exit(main())
