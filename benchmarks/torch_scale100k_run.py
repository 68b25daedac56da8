#!/usr/bin/env python3
"""run() at 100k cells, a port of benchmarks/scale100k_run.py (BASELINE.json
config 3): counts go in, run() does steps 2-23 with the Leiden
subclusters, the i6 HMM on the subclusters' means, the Bayesian filter
(BayesMaxPNormal=0.5), denoise, the region reports and the plots.

    python3 benchmarks/torch_scale100k_run.py [--cells 100000] [--no-plot]
        [--out_dir DIR] [--device cpu]

The counts (numpy, seed 0, the reference's draws): 9,000 genes on 22
chromosomes, a fifth of the cells normal in two groups, three tumour groups
with a planted 0.5x loss and 2x gain of a chromosome each.  Gates
(scale100k_run.py:102-126): each planted loss and gain called in more than
0.7 of its group's (cell, gene) pairs, the normal cells more than 0.95
neutral, at least as many subclusters as tumour groups, the region reports
written; the final heatmap where matplotlib renders, and where it is
missing (the run logs each render's failure and goes on) the heatmaps'
text outputs and every plot step's data side.  A gate that fails exits 1.
Prints a line "# {...}" with the device, the peak host RSS and the card's
peak memory, then the reference's JSON line (metric
run_e2e_100k_leiden_hmm_wall_clock).  Runs on the CUDA card unless given
--device cpu.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_scale1m as s1m  # noqa: E402

from infercnv_tpu_torch.core.object import InferCNV  # noqa: E402
from infercnv_tpu_torch.device import resolve_device  # noqa: E402
from infercnv_tpu_torch.runner.pipeline import run  # noqa: E402

CELLS = 100_000
GENES = 9000
#: run()'s options (scale100k_run.py:90-94)
RUN_KW = dict(cutoff=1.0, analysis_mode="subclusters", HMM=True, denoise=True,
              tumor_subcluster_partition_method="leiden", save_rds=False,
              inspect_subclusters=False)
#: the plot steps of such a run (runner/pipeline.py), each with a data side
PLOT_STEPS = ("15_prelim_plot", "17_state_plot", "20_proxy_plot", "23_final_plot")


def synth_genome(G: int = GENES, n_chr: int = 22):
    """The generator's genome: gene i at i * 1000 to i * 1000 + 500
    (scale100k_run.py:35-45)."""
    sizes = s1m.chromosome_sizes(G, n_chr)
    return s1m.gene_order(sizes, 1000, 500)


def tumour_layout(go, C: int, n_groups: int = 3):
    """The groups and the planted CNVs (scale100k_run.py:49-65,
    scale1m_run.py:54-72): n_ref = C // 5 normal cells in two groups, then
    n_groups tumour groups of consecutive cells (the last takes the
    remainder), group gi with chromosome 2gi + 2 at 0.5x and 2gi + 3 at 2x.
    Returns (reference groups, tumour groups, {group: (lost genes, gained
    genes)}, factors [n_groups + 1, G]: row 0 the reference cells' (ones),
    row gi + 1 group gi's)."""
    G = go.num_genes
    n_chr = len(go.chr_names)
    n_ref = C // 5
    ranges = go.chr_ranges()
    per_grp = (C - n_ref) // n_groups
    planted, tumor_groups = {}, {}
    factors = np.ones((n_groups + 1, G))
    for gi in range(n_groups):
        lo = n_ref + gi * per_grp
        hi = C if gi == n_groups - 1 else lo + per_grp
        tumor_groups[f"malignant_{gi+1}"] = np.arange(lo, hi)
        dci, aci = (2 * gi + 1) % n_chr, (2 * gi + 2) % n_chr
        db, de = ranges[dci]
        ab, ae = ranges[aci]
        factors[gi + 1, db:de] = 0.5
        factors[gi + 1, ab:ae] = 2.0
        planted[f"malignant_{gi+1}"] = (np.arange(db, de), np.arange(ab, ae))
    ref_groups = {"normal_a": np.arange(0, n_ref // 2),
                  "normal_b": np.arange(n_ref // 2, n_ref)}
    return ref_groups, tumor_groups, planted, factors


def synth_counts(C: int, G: int = GENES, n_chr: int = 22, n_groups: int = 3,
                 seed: int = 0):
    """scale100k_run.py:31-67: float32 Poisson counts [C, G] from numpy seed
    `seed`, gene means gamma(2, 8), drawn in one call over the whole rate
    matrix.  Returns (gene order, counts, reference groups, tumour groups,
    planted)."""
    go = synth_genome(G, n_chr)
    rng = np.random.default_rng(seed)
    gene_means = rng.gamma(2.0, 8.0, go.num_genes)
    ref_groups, tumor_groups, planted, factors = tumour_layout(go, C, n_groups)
    lam = np.broadcast_to(gene_means[None, :], (C, go.num_genes)).copy()
    for gi, idx in enumerate(tumor_groups.values()):
        lam[idx[0]:idx[-1] + 1] *= factors[gi + 1]
    counts = rng.poisson(lam).astype(np.float32)
    return go, counts, ref_groups, tumor_groups, planted


def have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


class FailedPlots(logging.Handler):
    """The port's warnings that a step failed, while installed (a with
    block): run() logs "<plot> failed: ..." and goes on."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.failed = []

    def emit(self, record):
        msg = record.getMessage()
        if " failed" in msg:
            self.failed.append(msg)

    def __enter__(self):
        logging.getLogger("infercnv_tpu_torch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("infercnv_tpu_torch").removeHandler(self)


def plot_gates(out_dir: str, records, failed, mpl: bool) -> dict:
    """The final heatmap where matplotlib renders (scale100k_run.py:124-126)
    and no plot failed; without matplotlib, each plot step's data side ran,
    the final heatmap's text outputs were written, and no plot failed but at
    the missing module."""
    steps = {r["step"] for r in records}
    files = set(os.listdir(out_dir))
    bad = [m for m in failed if mpl or "matplotlib" not in m]
    out = {"render": "matplotlib" if mpl else "matplotlib not installed",
           "plot_failures": len(failed), "no_other_failure": not bad}
    if mpl:
        out["final_heatmap"] = "infercnv.png" in files
    else:
        out["data_sides"] = all(f"{s}.data" in steps for s in PLOT_STEPS)
        out["text_outputs"] = {"infercnv.observation_groupings.txt",
                               "infercnv.heatmap_thresholds.txt"} <= files
    return out


def call_gates(res, tumor_groups, planted, sample_cells: int = 0) -> dict:
    """scale100k_run.py:102-123 (scale1m_run.py:148-171 with sample_cells =
    20000: every idx.size // 20000-th cell of a group): each planted loss
    and gain called above 0.7, the normal cells above 0.95 neutral, at
    least as many subclusters as tumour groups."""
    st = res.hmm_states
    final = res.infercnv_obj
    n_sub = sum(len(s) for s in final.tumor_subclusters["subclusters"].values())
    gene_lut = {n: i for i, n in enumerate(final.gene_order.names)}

    def sample(idx):
        return idx[::max(1, idx.size // sample_cells)] if sample_cells else idx

    called = {}
    for g, idx in tumor_groups.items():
        del_genes, amp_genes = planted[g]
        dsel = [gene_lut[f"g{i}"] for i in del_genes if f"g{i}" in gene_lut]
        asel = [gene_lut[f"g{i}"] for i in amp_genes if f"g{i}" in gene_lut]
        sub = sample(idx)
        called[g] = {"del": float((st[np.ix_(sub, dsel)] < 3).mean()),
                     "amp": float((st[np.ix_(sub, asel)] > 3).mean())}
        print(f"# {g}: planted del called {called[g]['del']:.2f}, "
              f"amp called {called[g]['amp']:.2f}", flush=True)
    neu = float((st[sample(final.all_ref_idx())] == 3).mean())
    print(f"# reference neutral fraction: {neu:.3f}; subclusters found: {n_sub}",
          flush=True)
    return {"called": called, "reference_neutral": neu, "subclusters": n_sub,
            "all_called": all(v["del"] > 0.7 and v["amp"] > 0.7 for v in called.values()),
            "neutral": neu > 0.95, "enough_subclusters": n_sub >= len(tumor_groups)}


def step_timings(out_dir: str) -> dict:
    """step_timings.tsv as {step: seconds rounded to 0.01}
    (scale100k_run.py:128-136)."""
    timings = {}
    tsv = os.path.join(out_dir, "step_timings.tsv")
    if os.path.exists(tsv):
        for line in open(tsv):
            k, v = line.strip().split("\t")[:2]
            try:
                timings[k] = round(float(v), 2)
            except ValueError:
                continue  # header row
    return timings


def product_gates(res, out_dir: str, tumor_groups, planted, no_plot: bool, failed,
                  sample_cells: int = 0) -> dict:
    """Every gate of the run: the calls, the region reports, the plots."""
    g = call_gates(res, tumor_groups, planted, sample_cells)
    g["region_reports"] = any(f.endswith("pred_cnv_regions.dat")
                              for f in os.listdir(out_dir))
    if not no_plot:
        g["plots"] = plot_gates(out_dir, res.timer.records, failed, have_matplotlib())
    return g


def gates_passed(g: dict) -> bool:
    return (s1m.passed(g) and s1m.passed(g.get("plots", {})))


def run_timed(obj, out_dir: str, dev, no_plot: bool, **kw):
    """run() with the script's options; returns (result, wall seconds, the
    plot failures logged)."""
    s1m.sync(dev)
    with FailedPlots() as fp:
        t1 = time.perf_counter()
        res = run(obj, out_dir=out_dir, device=dev, no_plot=no_plot, **RUN_KW, **kw)
        s1m.sync(dev)
        dt = time.perf_counter() - t1
    return res, dt, fp.failed


def metric_line(metric: str, C: int, res, dt: float, out_dir: str, **extra) -> dict:
    """The reference's JSON line (scale100k_run.py:138-147)."""
    final = res.infercnv_obj
    n_sub = sum(len(s) for s in final.tumor_subclusters["subclusters"].values())
    return {"metric": metric, "cells": C, "genes": int(final.num_genes),
            "subclusters": int(n_sub), "value": round(dt, 2), "unit": "s",
            "cells_per_sec": round(C / dt, 1), **extra,
            "step_timings": step_timings(out_dir), "out_dir": out_dir}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=CELLS)
    ap.add_argument("--no-plot", action="store_true")
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--device", default=None, help="the CUDA card by default; 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    C = args.cells
    t0 = time.perf_counter()
    go, counts, ref_groups, tumor_groups, planted = synth_counts(C)
    t_gen = time.perf_counter() - t0
    print(f"# generated {C} cells x {go.num_genes} genes in {t_gen:.1f}s", flush=True)
    obj = InferCNV(
        expr=counts.copy(), counts=counts, gene_order=go,
        cell_names=[f"c{i}" for i in range(C)],
        ref_groups=ref_groups, obs_groups=tumor_groups,
    )
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="icnv100k_")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res, dt, failed = run_timed(obj, out_dir, dev, args.no_plot)
    g = product_gates(res, out_dir, tumor_groups, planted, args.no_plot, failed)
    print("# " + json.dumps({"device": s1m.device_name(dev), "generate_s": t_gen,
                             "wall_s": dt, "peak_host_rss_gb": s1m.peak_rss_gb(),
                             "peak_card_gb": s1m.card_peak_gb(dev), "gates": g}),
          flush=True)
    print(json.dumps(metric_line("run_e2e_100k_leiden_hmm_wall_clock", C, res, dt,
                                 out_dir)), flush=True)
    return 0 if gates_passed(g) else 1


if __name__ == "__main__":
    sys.exit(main())
