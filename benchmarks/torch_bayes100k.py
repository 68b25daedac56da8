#!/usr/bin/env python3
"""Steps 18-19 alone at 100k cells, a port of benchmarks/bayes100k.py
(BASELINE.json config 4): the Bayesian mixture filter over a whole atlas.

    python3 benchmarks/torch_bayes100k.py [--cells N] [--subclusters K]
        [--device cpu]

A synthetic 100k-cell x 8,448-gene residual on 22 chromosomes (numpy, seed
1, as the reference draws it): a tenth of the cells normal, the rest in 32
tumour subclusters with one or two planted loss or gain regions each (~48),
and the matching state matrix.  A real hspike is calibrated first: counts
of a 512-cell object on the same genome, built and carried through the
step 4-14 chain as run() does (models/hspike.build_hspike,
runner/pipeline._hspike_residual_chain).  Then the timed part,
bayesian_filter_states with report_by="subcluster": the host region
descriptors from the state matrix, the log-likelihood's products over cell
chunks, the Gibbs sampler (6 chains x 1,200 sweeps) over every region
block, removeCNV + reassignCNV and the CNV_State_Probabilities.dat write.

Gates (bayes100k.py:147-157): at least as many modelled regions as
planted, at most a tenth removed, 90% with an argmax on the planted side
of neutral; a gate that fails exits 1.  Prints a line "# {...}" with the
device, the filter's parts, the peak host RSS, the card's peak memory and
the gates, then the reference's JSON line (metric
bayes_filter_100k_wall_clock).  Runs on the CUDA card unless given
--device cpu.
"""

from __future__ import annotations

import argparse
import json
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
from infercnv_tpu_torch.models import hmm as hmm_mod  # noqa: E402
from infercnv_tpu_torch.models.bayes import bayesian_filter_states  # noqa: E402
from infercnv_tpu_torch.models.hspike import build_hspike  # noqa: E402
from infercnv_tpu_torch.ops import transforms as T  # noqa: E402
from infercnv_tpu_torch.runner.config import RunConfig  # noqa: E402
from infercnv_tpu_torch.runner.pipeline import _hspike_residual_chain  # noqa: E402

CELLS = 100_000
SUBCLUSTERS = 32
CHAINS, SWEEPS = 6, 1200   # the filter's defaults, as the reference reports them


def build_genome(G: int = 8448, n_chr: int = 22):
    """8448 genes on 22 chromosomes, gene i at i * 1000 to i * 1000 + 500
    (bayes100k.py:33-44).  Returns (GeneOrder, sizes)."""
    sizes = s1m.chromosome_sizes(G, n_chr)
    return s1m.gene_order(sizes, 1000, 500), sizes


def calibrated_hspike(go, dev, seed: int = 0):
    """A real hspike (bayes100k.py:47-69): Poisson counts of a 512-cell
    object on the same genome (256 normal, 256 tumour), depth-normalised,
    built with the meanvar simulation and carried through the step 4-14
    chain as run() does."""
    rng = np.random.default_rng(seed)
    G = go.num_genes
    gene_means = rng.gamma(2.0, 30.0, G)
    counts = rng.poisson(gene_means[None, :] * np.ones((512, 1))).astype(np.float32)
    obj = InferCNV(
        expr=counts.copy(), counts=counts, gene_order=go,
        cell_names=[f"h{i}" for i in range(512)],
        ref_groups={"normal": np.arange(256)},
        obs_groups={"tumor": np.arange(256, 512)},
    )
    obj.expr = np.asarray(T.normalize_counts_by_seq_depth(obj.expr))
    h = build_hspike(obj, sim_method="meanvar", seed=12345)
    _hspike_residual_chain(h, RunConfig(out_dir="."), 3.0, dev)
    return h


def state_means(hspike) -> np.ndarray:
    """The i6 states' means of the hspike's spike distributions."""
    dists = hmm_mod.get_spike_dists(hspike)
    return np.array([dists[lvl][0] for lvl in hmm_mod.I6_LEVELS])


def planted_dataset(go, mu, C: int = CELLS, K: int = SUBCLUSTERS):
    """The residual-space expression and states with planted regions
    (bayes100k.py:94-136): expr ~ N(1, 0.18), C // 10 normal cells, the
    rest in K subclusters of consecutive cells; subcluster k gets 1 + k % 2
    regions of a third of a chromosome (40 genes at least), at state 2
    (expr ~ N(mu[1], 0.18)) or 4 (N(mu[3], 0.18)) alternately.  Returns
    (object, states int8 [C, G], [(subcluster, genes, state)])."""
    rng = np.random.default_rng(1)
    G = go.num_genes
    n_ref = C // 10
    expr = rng.normal(1.0, 0.18, (C, G)).astype(np.float32)
    states = np.full((C, G), 3, np.int8)
    tumor_idx = np.arange(n_ref, C)
    sub_bounds = np.linspace(0, tumor_idx.size, K + 1).astype(int)
    subclusters = {}
    chr_ranges = go.chr_ranges()
    planted = []
    for k in range(K):
        sidx = tumor_idx[sub_bounds[k]:sub_bounds[k + 1]]
        subclusters[f"tumor_s{k+1}"] = sidx
        for j in range(1 + (k % 2)):
            ci = (3 * k + 7 * j) % len(chr_ranges)
            b, e = chr_ranges[ci]
            span = max(40, (e - b) // 3)
            gsel = np.arange(b, min(b + span, e))
            state = 2 if (k + j) % 2 == 0 else 4
            expr[np.ix_(sidx, gsel)] = rng.normal(
                mu[state - 1], 0.18, (sidx.size, gsel.size))
            states[np.ix_(sidx, gsel)] = state
            planted.append((k, gsel, state))
    obj = InferCNV(
        expr=expr, counts=None, gene_order=go,
        cell_names=[f"c{i}" for i in range(C)],
        ref_groups={"normal": np.arange(n_ref)},
        obs_groups={"tumor": tumor_idx},
        tumor_subclusters={"hc": {}, "subclusters": {
            "tumor": subclusters, "normal": {"normal_s1": np.arange(n_ref)}}},
    )
    return obj, states, planted


def gates(result, n_planted: int) -> dict:
    """bayes100k.py:147-157: every planted region modelled, at most a tenth
    removed by the P(normal) filter, 90% with the argmax on the planted
    side of neutral."""
    probs = result.cnv_state_probabilities  # [S, R]
    R = len(result.regions)
    ok_dir = 0
    for ri, rdesc in enumerate(result.regions):
        am = int(np.argmax(probs[:, ri]))
        if (rdesc["state"] < 3) == (am < 2) or (rdesc["state"] > 3) == (am > 2):
            ok_dir += 1
    removed = len(result.removed_regions)
    return {"regions": R, "planted": n_planted, "removed": removed,
            "direction_consistent": ok_dir, "max_p_normal": float(probs[2].max()),
            "all_modelled": R >= n_planted, "few_removed": removed <= R // 10,
            "directions": ok_dir >= int(0.9 * R)}


def metric_line(C: int, R: int, dt: float) -> dict:
    """The reference's JSON line (bayes100k.py:159-165)."""
    return {"metric": "bayes_filter_100k_wall_clock", "cells": C, "regions": R,
            "chains": CHAINS, "sweeps": SWEEPS, "value": round(dt, 2), "unit": "s",
            "cells_per_sec": round(C / dt, 1)}


def run_filter(obj, states, hspike, dev, out_dir: str):
    """The timed part: bayesian_filter_states over every modelled region.
    Returns (filtered states, BayesResult, seconds)."""
    s1m.sync(dev)
    t0 = time.perf_counter()
    new_states, result = bayesian_filter_states(
        obj, states.astype(np.int32), hmm_type="i6", BayesMaxPNormal=0.5,
        hspike=hspike, out_dir=out_dir, report_by="subcluster", device=dev)
    s1m.sync(dev)
    return new_states, result, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=CELLS)
    ap.add_argument("--subclusters", type=int, default=SUBCLUSTERS)
    ap.add_argument("--device", default=None, help="the CUDA card by default; 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    go, _sizes = build_genome()

    t0 = time.perf_counter()
    hspike = calibrated_hspike(go, dev)
    mu = state_means(hspike)
    t_hspike = time.perf_counter() - t0
    print(f"# hspike calibration: {t_hspike:.1f}s, state means {np.round(mu, 3)}",
          flush=True)
    t0 = time.perf_counter()
    obj, states, planted = planted_dataset(go, mu, args.cells, args.subclusters)
    t_data = time.perf_counter() - t0
    print(f"# planted {len(planted)} regions in {args.cells} cells in {t_data:.1f}s",
          flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as td:
        _new_states, result, dt = run_filter(obj, states, hspike, dev, td)
    g = gates(result, len(planted))
    print(f"# regions modeled: {g['regions']}; removed: {g['removed']}; "
          f"direction-consistent argmax: {g['direction_consistent']}/{g['regions']}; "
          f"max P(normal): {g['max_p_normal']:.3f}", flush=True)
    print("# " + json.dumps({
        "device": s1m.device_name(dev), "wall_s": dt, "parts_s": result.seconds,
        "sampler_sweeps": result.sweeps, "hspike_s": t_hspike, "data_s": t_data,
        "peak_host_rss_gb": s1m.peak_rss_gb(), "peak_card_gb": s1m.card_peak_gb(dev),
        "gates": g}), flush=True)
    print(json.dumps(metric_line(args.cells, g["regions"], dt)), flush=True)
    return 0 if s1m.passed(g) else 1


if __name__ == "__main__":
    sys.exit(main())
