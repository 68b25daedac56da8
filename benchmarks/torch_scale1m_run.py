#!/usr/bin/env python3
"""run() at 1M cells on one card, a port of benchmarks/scale1m_run.py
(BASELINE.json config 5): everything benchmarks/torch_scale100k_run.py
does (Leiden subclusters, the i6 HMM on the subclusters' means, the
Bayesian filter, denoise, the region reports, the plots) at 10x the cells,
with the options that bound host memory:

  * the counts are uint16, drawn in row blocks (18 GB at 1M x 9,000) into
    host memory, as the reference draws them; with --counts_cache into
    that .npy file instead, handed to run() as a read-only disk memmap
    that run() reads through the file, so the caller then holds no copy
    of them in host memory beside step 2's gene-filtered one (a call on
    the H100's machine may write 45 GiB to its disk: the 18 GB file and
    the 36 GB residual memmap do not fit one call);
  * the engine's chunks come back as float16 (engine_transfer_dtype; the
    fused kernel stores float16 itself) into a disk-backed float32 memmap
    (residual_memmap_gb=20.0), so the 36 GB residual is not held in RAM;
  * step 15 slices each group lazily from the memmap, and step 22 denoises
    block-wise in place (run()'s own 2e9-element rules switch both on).

    python3 benchmarks/torch_scale1m_run.py [--cells 1000000] [--no-plot]
        [--out_dir DIR] [--counts_cache PATH.npy] [--device cpu]

The gates are scale1m_run.py:146-174's (those of torch_scale100k_run.py,
the calls read on every idx.size // 20000-th cell of a group).  Prints a
line "# {...}" with the device, the machine's RAM and free disk before the
counts were made, each step's seconds and resident set (VmRSS, RssAnon,
RssFile at its end), the peak host RSS, the card's peak memory, the
kernels' launches and the gates,
then the reference's JSON line (metric run_e2e_1m_leiden_hmm_wall_clock).
A gate that fails exits 1.  Runs on the CUDA card unless given --device
cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_scale1m as s1m  # noqa: E402
import torch_scale100k_run as s100k  # noqa: E402

from infercnv_tpu_torch.core.object import InferCNV  # noqa: E402
from infercnv_tpu_torch.device import resolve_device  # noqa: E402
from infercnv_tpu_torch.utils.memmap import write_rows  # noqa: E402

CELLS = 1_000_000
#: rows a numpy Poisson call draws (scale1m_run.py:80)
BLOCK = 50_000
MEMMAP_GB = 20.0
#: the options scale1m_run.py:137-144 adds to scale100k_run.py's
SCALE_KW = dict(engine_chunk_cells=32768, engine_transfer_dtype="float16")
#: the group calls are read on every idx.size // SAMPLE_CELLS-th cell
SAMPLE_CELLS = 20000


def row_bounds(C: int, n_groups: int = 3) -> list:
    """Row boundaries of the reference cells and each tumour group
    (scale1m_run.py:76)."""
    n_ref = C // 5
    per_grp = (C - n_ref) // n_groups
    return [0, n_ref] + [n_ref + gi * per_grp for gi in range(1, n_groups)] + [C]


def synth_counts_streamed(C: int, G: int = s100k.GENES, n_chr: int = 22,
                          n_groups: int = 3, seed: int = 0, gen_counts: bool = True,
                          out=None):
    """scale1m_run.py:37-86: torch_scale100k_run's genome, groups and
    planted CNVs, the counts Poisson-drawn (numpy seed `seed`, gene means
    gamma(2, 8)) in blocks of BLOCK rows of one row group straight into a
    preallocated uint16 matrix (`out` when given, e.g. a disk memmap,
    written through its file); gen_counts=False skips the
    counts (None).  Returns (gene order, counts, reference groups, tumour
    groups, planted)."""
    go = s100k.synth_genome(G, n_chr)
    rng = np.random.default_rng(seed)
    gene_means = rng.gamma(2.0, 8.0, go.num_genes)
    ref_groups, tumor_groups, planted, factors = s100k.tumour_layout(go, C, n_groups)
    if not gen_counts:
        return go, None, ref_groups, tumor_groups, planted
    counts = np.empty((C, go.num_genes), np.uint16) if out is None else out
    bounds = row_bounds(C, n_groups)
    for row_grp in range(n_groups + 1):
        lo, hi = bounds[row_grp], bounds[row_grp + 1]
        lam = gene_means * factors[row_grp]
        for b in range(lo, hi, BLOCK):
            e = min(b + BLOCK, hi)
            write_rows(counts, b,
                       rng.poisson(lam[None, :], (e - b, go.num_genes)).astype(np.uint16))
    return go, counts, ref_groups, tumor_groups, planted


def machine_room(path) -> dict:
    """The machine's RAM (/proc/meminfo, as `free` reads it) and the free
    disk under `path`, in GB."""
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":")
            mem[k] = int(v.split()[0]) * 1024
    return {"ram_total_gb": mem["MemTotal"] / 1e9,
            "ram_available_gb": mem["MemAvailable"] / 1e9,
            "disk_free_gb": shutil.disk_usage(path).free / 1e9}


def counts_from(C: int, path: Optional[str] = None):
    """The counts: drawn into host memory without a path; else a read-only
    disk memmap of the .npy file `path`, the file as it is when it exists
    (a cache of an earlier run), else drawn into it first
    (scale1m_run.py:112-127 draws into host memory and saves the cache
    after)."""
    t0 = time.perf_counter()
    if not path:
        go, counts, ref_groups, tumor_groups, planted = synth_counts_streamed(C)
        print(f"# generated {C} cells x {go.num_genes} genes (uint16, "
              f"{counts.nbytes / 1e9:.1f} GB) in {time.perf_counter() - t0:.1f}s",
              flush=True)
        return go, counts, ref_groups, tumor_groups, planted, time.perf_counter() - t0
    go, _c, ref_groups, tumor_groups, planted = synth_counts_streamed(C, gen_counts=False)
    if os.path.exists(path):
        counts = np.load(path, mmap_mode="r")
        if counts.shape != (C, go.num_genes):
            raise ValueError(f"{path} holds counts of shape {counts.shape}, "
                             f"not {(C, go.num_genes)}")
        print(f"# loaded cached counts {counts.shape} from {path} in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    else:
        out = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint16,
                                        shape=(C, go.num_genes))
        synth_counts_streamed(C, out=out)
        del out
        counts = np.load(path, mmap_mode="r")
        print(f"# generated {C} cells x {go.num_genes} genes (uint16, "
              f"{counts.nbytes / 1e9:.1f} GB, into {path}) in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    return go, counts, ref_groups, tumor_groups, planted, time.perf_counter() - t0


def run_scaled(obj, out_dir: str, dev, no_plot: bool, memmap_gb: float = MEMMAP_GB):
    """run() with the script's options (scale1m_run.py:136-144)."""
    return s100k.run_timed(obj, out_dir, dev, no_plot, residual_memmap_gb=memmap_gb,
                           **SCALE_KW)


def launches() -> dict:
    """Each kernel wrapper's launch count in this process (chip_smoke.py's
    names); the program runs run() once, so they are that run's."""
    from infercnv_tpu_torch.ops import median, residual_fused, smoothing, viterbi_kernel

    return {"residual_fused": residual_fused.LAUNCHES,
            "residual_fused_bf16": residual_fused.LAUNCHES_BF16,
            "viterbi": viterbi_kernel.LAUNCHES, "smooth_banded": smoothing.LAUNCHES,
            "smooth_banded_bf16": smoothing.LAUNCHES_BF16,
            "smooth_general": smoothing.LAUNCHES_GENERAL,
            "median_center_residual": median.LAUNCHES_EPILOGUE,
            "row_median": median.LAUNCHES}


def gates(res, out_dir: str, tumor_groups, planted, no_plot: bool, failed) -> dict:
    return s100k.product_gates(res, out_dir, tumor_groups, planted, no_plot, failed,
                               sample_cells=SAMPLE_CELLS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=CELLS)
    ap.add_argument("--no-plot", action="store_true")
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--counts_cache", default=None,
                    help="path (.npy) to keep the generated uint16 counts in, handed to "
                         "run() as a disk memmap (re-launches skip the generation)")
    ap.add_argument("--device", default=None, help="the CUDA card by default; 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    C = args.cells
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="icnv1m_")
    os.makedirs(out_dir, exist_ok=True)
    room = machine_room(out_dir)
    print("# " + json.dumps({"machine": room}), flush=True)
    go, counts, ref_groups, tumor_groups, planted, t_gen = counts_from(C, args.counts_cache)
    obj = InferCNV(expr=counts, counts=counts, gene_order=go,
                   cell_names=[f"c{i}" for i in range(C)],
                   ref_groups=ref_groups, obs_groups=tumor_groups)
    del counts
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res, dt, failed = run_scaled(obj, out_dir, dev, args.no_plot)
    del obj
    g = gates(res, out_dir, tumor_groups, planted, args.no_plot, failed)
    print("# " + json.dumps({"device": s1m.device_name(dev), "machine": room,
                             "generate_s": t_gen, "wall_s": dt,
                             "step_seconds": res.timer.records,
                             "peak_host_rss_gb": s1m.peak_rss_gb(),
                             "peak_card_gb": s1m.card_peak_gb(dev),
                             "launches": launches(), "gates": g}),
          flush=True)
    print(json.dumps(s100k.metric_line("run_e2e_1m_leiden_hmm_wall_clock", C, res, dt,
                                       out_dir, peak_host_rss_gb=round(s1m.peak_rss_gb(), 2))),
          flush=True)
    return 0 if s100k.gates_passed(g) else 1


if __name__ == "__main__":
    sys.exit(main())
