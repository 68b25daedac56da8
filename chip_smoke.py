#!/usr/bin/env python3
"""Smoke run of infercnv_tpu_torch on one CUDA card.

    python3 chip_smoke.py          (from the root of the repository)

Phases, each printing one JSON line:
  device      the card (nvidia-smi name and power limit), CUDA, TF32 flags
  build       nvcc builds the kernels from infercnv_tpu_torch/csrc
  routes      the route each path's engine takes (residual and smooth), and
              the coordinates band (halfband, nonzeros, taps a tile)
  kernels     each CUDA kernel against its plain PyTorch version on the card,
              at the shapes its path gives it and at awkward ones (the
              Viterbi in both regimes of its launch plan, and with its
              backpointers in device memory), with times (CUDA
              events; the one-row smooth and the Viterbi, calls of tens of
              microseconds, as 20 calls in a CUDA graph)
  ref_stats   ref_stats' three row kernels (log_norm, ref_centred, noise_rows)
              against their plain versions at the benchmark's shape
              ([13,108, 8448] u16, 2 groups) and at 8447 genes, each one's
              ms beside its bound; the engine's ref_stats against the
              op-by-op form on each path's engine (main, coordinates, wide
              genome, bf16) and at that shape, with its launches a call
              (3 where the front fits, else 2) and ms against the ops'
              (chip_smoke.py --ref-stats runs this phase alone)
  main_path   the bench workload on the port: 8448 genes on 22 chromosomes,
              u16 counts, 32768-cell chunks, 256 reference cells in 2 groups,
              16 subclusters with a planted 0.5x loss on chr2 and 2x gain on
              chr5 in subclusters 8-15: ref_stats, 12 subcluster_chunk calls
              with accumulation, viterbi_group_means; the fused residual,
              ref_stats' three and the Viterbi kernels must be launched and
              the planted CNVs called
  coords_i3_path  coordinate smoothing (10 Mbp window) with the i3 HMM on a
              genome shaped like GRCh38 (human_like_genome, 8448 genes):
              ref_stats, the i3 parameters from the transformed reference
              cells, 12 subcluster_chunk calls of 32768 cells, the 3-state
              group-mean Viterbi; the general smooth, the row median and the
              Viterbi must be launched and the planted CNVs called (i3
              states 1 and 3)
  wide_genome_path  60,000 genes of the same construction, pyramidal window
              101, 2 chunks of 8192 cells: the row is too wide for the fused
              kernel, so the general smooth and the median-centred tail run
  bf16_path   the bench workload with matmul_dtype="bfloat16", 2 chunks: the
              fused kernel's bf16 variant and its front run, and the
              group-mean states equal the f32 engine's on the same chunks
  reference   the default engine on 512 cells, the card against the CPU
  coords_reference  the coordinates + i3 engine on 512 cells, the card
              against the CPU, full_chunk included
  bayes_sampler  the Bayesian filter's Gibbs sampler (PyTorch ops, no
              kernel of its own) on tests/test_bayes_scale.py's three cases,
              then timed on one block of the Bayes workload's size (48
              regions x 3,125 cells, 6 states, 6 chains, 1,200 sweeps)
  run_i6_subclusters, run_i3_coords_cells  run() on 34,816 (i3: 18,432)
              cells x 8448 genes (make_run_object): i6 with qnorm
              subclusters and the Bayesian filter at BayesMaxPNormal=0.5,
              the planted calls gated on the filtered states and reports;
              i3 with the coordinates smooth in cells mode
              (BayesMaxPNormal=0)
  run_i6_leiden  the same object, run()'s default Leiden partition with
              cluster_by_groups=False, the Bayesian filter and the plots at
              the reference's defaults (no_plot=False, png_res=300,
              inspect_subclusters, plot_probabilities): one 32,768-cell
              group (tiled kNN, the dendrogram on device-computed
              subcluster profiles), step 15 from the residual kept on the
              card; each plot step's seconds, data side and render apart,
              every plot file there, no plot failed
  run_op_by_op  the same object, use_engine=False up to step 14 (kernels
              3 and 7 through the chromosome smooth and the centring),
              against the engine's residual within 2e-4
  plots       whether matplotlib renders here (the heatmaps' data side
              runs on the card either way; without matplotlib each plot
              step fails at its render, as the reference lets it, and the
              render gates below are reported as not run)
  heatmap_data  the heatmap's data side (viz/heatmap.py) on the Leiden
              run's final object, 34,816 x 8448, on the card and on the
              CPU: the centre, the range (sampled, and exact over the
              whole matrix), the orders (the Leiden subclusters' linkages;
              the PC1 order of eight 4,096-cell groups), the panes and the
              key's histogram, held card against CPU, with each side's
              seconds and the card's peak memory
  run_reference, run_subcluster_reference  run() on 1,024 cells (the
              op-by-op options with random_trees on 512), the card against
              the CPU: i6 with qnorm at the full defaults
              (BayesMaxPNormal=0.5, save_rds=True, the plots,
              diagnostics=True: modelled regions, posteriors, filtered
              states, checkpoints, the final RDS read back, the plots'
              files, groupings, thresholds and PNG fingerprints, and a
              second run() that resumes); the Leiden with per-chromosome
              subclusters and HMM; the op-by-op options with random_trees,
              split references and the DE mask
  mesh_engine the main path's engine over CellMesh([card, card]): two
              32,768-cell chunks through subcluster_chunk and the group
              Viterbi, against the unsharded engine (residual within 2e-5,
              group sums within float32 summation order, states equal),
              cells/s of both and the launches a shard
  mesh_stats  sharded_median, sharded_quantile (0.01, 0.99) and
              sharded_group_gene_stats on a 2-shard mesh of the card over
              run_i6_subclusters' 34,816 library sizes and final rows,
              against numpy (exact; means within 1e-6 relative)
  mesh_run    run(mesh=CellMesh([card, card])) on run_reference's object in
              subcluster and cell mode against the one-device card run
  multiprocess  two processes on the card under gloo (chip_smoke.py
              --worker RANK WORLD PORT DIR DEVICE), each loading its .npy slice
              with load_counts_shard: the sharded median, group statistics,
              engine and run() against one process; then a one-rank NCCL
              group through sharded_median and to_host
  entry_points  the CLI on files written from run_reference's object
              (--HMM --denoise --median_filter) against a direct run(),
              run(sim_method="splatter") gated on its planted calls, and
              the median filter card against CPU, timed on the Leiden
              run's object (or one 4,096-cell group of it)
  scale_reference  the 1M-cell configuration's options (float16 chunk
              downloads, the residual in a disk memmap, lazy per-group
              slicing and the in-place denoise forced) on run_reference's
              1,024 cells, qnorm and Leiden, the card against the CPU: the
              final expr within one float16 ulp but at the denoise band's
              edge, the states and reports equal, each route taken
  scale1m_cells, scale1m_subclusters, scale100k, bayes100k, scale100k_run
              the scale programs at their full sizes, each in a process of
              its own (chip_smoke.py --program-worker PHASE DIR), one after
              another after run_scale, beside the run phases above
              (started before run_i6_subclusters, waited for at the end):
              benchmarks/torch_scale1m.py in both modes (1,048,576 cells
              drawn on the card), torch_scale100k.py (98,304 cells staged on
              the card), torch_bayes100k.py (steps 18-19 at 100,000 cells)
              and torch_scale100k_run.py (run() at 100,000 cells with the
              plots); each line: seconds, cells/s, peak host RSS, the card's
              peak memory, the program's gates and its launches
  run_scale   run() at 262,144 cells x 9,000 genes with those options
              (benchmarks/torch_scale1m_run.py's run and gates, the cells cut
              from 1M, the counts drawn on the card), in a process of its
              own, first in the scale programs' queue beside the run phases
              (chip_smoke.py --scale-worker DIR runs it alone): the
              planted calls, each route taken, kernels 1, 2, 3 and 7
              launched, each step's seconds, peak host RSS and the card's
              memory before and after; before it, a line run_scale_memory
              with each step's resident set (VmRSS, RssAnon, RssFile) and
              the gate on it after steps 4-14 (SCALE_RSS_RESIDUAL_FRACTION)
  leiden_fidelity  scripts/torch_leiden_fidelity.py at 1,000 and 5,000
              cells (after entry_points): the SNN components, the Leiden
              clusters, purity and the CPM scores; the Leiden CPM at least
              the components' and the planted partition's
Each path phase runs two warm-up chunks, then sets every launch count to 0
just before it and reads them just after; besides its wall-clock rate it
reports the chunks' mean device span (CUDA events).  Then the kernel table as one JSON line, the nvidia-smi line, and
last {"ok": true, "device": {...}}.  Any failure exits non-zero before that
line; without a CUDA device, or without the package beside this file, it
exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
import logging
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
CHUNK = 32768
N_SUB = 16
N_REF = 256
N_ITER = 12
RESID_TOL = 2e-5            # rtol = atol, as the reference's residual tests
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
#: flops counted per valid (position, state) of the Viterbi: emission
#: (sub, abs, div, u, 15-term Horner, log) ~ 34, forward step ~ 6
VITERBI_FLOPS = 40
#: the i6 emission parameters of the bundled example's hspike (bench.py)
BENCH_MEANS = (0.135, 0.631, 1.0, 1.346, 1.702, 2.237)
BENCH_SDS = (0.221, 0.252, 0.211, 0.288, 0.341, 0.457)
#: coordinate smoothing as run() configures it (reference
#: R/inferCNV_ops.R:353-361): a 10 Mbp window, with the i3 HMM
COORD_WINDOW = 10_000_000
WIDE_GENES = 60_000
WIDE_CHUNK = 8192
N_SHORT_ITER = 2            # chunks of the wide-genome and bf16 paths
N_CHECK = 512               # cells of the card-against-CPU checks
REF_CHUNK = 16384           # rows of ref_stats' chunks above its threshold
BENCH_REF_CELLS = 13_108    # ref_stats' rows in the benchmark (cnvbench/traffic)
ODD_REF_CELLS = 1_024       # rows of the 8447-gene ref_stats kernels check
#: the run phases' objects: 8 observation groups (4-7 with the planted loss
#: on chr2 and gain on chr5) and 2 reference groups, every group under the
#: hclust partition's LINKAGE_MAX_CELLS (8,000)
RUN_OBS = 4096
RUN_REF = 1024
#: run_i3_coords_cells' observation groups, half RUN_OBS (18,432 cells) so
#: that the script, with run_scale, stays within its time limit
RUN_I3_OBS = 2048
RUN_CHECK_OBS = 96          # run_reference: 8 x 96 + 2 x 128 = 1,024 cells
RUN_CHECK_REF = 128
#: the run phases at 34,816 cells keep save_rds=False: a compressed
#: checkpoint of the 1.18 GB matrix a step, and the gzipped float64 RDS of
#: 294 M values, cost minutes of host time there; checkpoints, resume and
#: the RDS run in run_reference (1,024 cells)
RUN_KW = dict(denoise=True, save_rds=False, no_plot=True)
#: the Bayes workload of benchmarks/bayes100k.py (BASELINE config 4):
#: 100,000 cells in 32 tumour subclusters, ~50 regions, i6 (6 states, 6
#: chains, 200 + 1,000 sweeps): one region block of 48 regions x 3,125 cells
BAYES_R, BAYES_CMAX = 48, 3125
#: GRCh38 chromosome lengths, chr1..chr22, in Mbp
GRCH38_MBP = (248.96, 242.19, 198.30, 190.21, 181.54, 170.81, 159.35, 145.14,
              138.39, 133.80, 135.09, 133.28, 114.36, 107.04, 101.99, 90.34,
              83.26, 80.37, 58.62, 64.44, 46.71, 50.82)
#: approximate protein-coding gene counts per chromosome (relative weights)
PROTEIN_CODING = (2050, 1300, 1080, 750, 880, 1040, 920, 690, 780, 730, 1310,
                  1030, 320, 610, 600, 850, 1180, 270, 1470, 540, 230, 440)


#: the script's start: each phase line carries its seconds since (t_s)
T_START = time.perf_counter()


def emit(**kv):
    print(json.dumps({**kv, "t_s": round(time.perf_counter() - T_START, 1)}), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


class Check(Exception):
    pass


def require(cond: bool, msg: str):
    if not cond:
        raise Check(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median of `reps` timed calls (CUDA events) after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device time of one call: n calls captured in a CUDA graph, the graph
    replayed (median of reps, CUDA events), divided by n.  Calls of tens of
    microseconds take longer on the host than on the card; timed one at a
    time (time_ms) they measure the host."""
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    ms = time_ms(g.replay, reps=reps) / n
    del g
    return ms


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bench_genome(G: int = 8448):
    """bench.py's genome: 8448 genes (or G) on 22 chromosomes."""
    import numpy as np

    from infercnv_tpu_torch.core.genome import GeneOrder

    sizes = np.linspace(800, 120, 22).astype(int)
    sizes = (sizes / sizes.sum() * G).astype(int)
    sizes[0] += G - sizes.sum()
    G = int(sizes.sum())
    return GeneOrder(names=tuple(f"g{i}" for i in range(G)),
                     chr_names=tuple(f"chr{i + 1}" for i in range(22)),
                     chr_ids=np.repeat(np.arange(22), sizes).astype(np.int32),
                     start=np.arange(G), stop=np.arange(G))


def human_like_genome(G: int, seed: int = SEED):
    """G genes on the 22 autosomes of GRCh38: chromosome lengths as there,
    genes per chromosome in proportion to their protein-coding genes (the
    remainder to chr1), starts uniform along each chromosome and sorted,
    lengths 5-60 kbp."""
    import numpy as np

    from infercnv_tpu_torch.core.genome import GeneOrder

    rng = np.random.default_rng(seed)
    w = np.asarray(PROTEIN_CODING, np.float64)
    n = (w / w.sum() * G).astype(int)
    n[0] += G - n.sum()
    starts, stops = [], []
    for mbp, k in zip(GRCH38_MBP, n):
        s = np.sort(rng.integers(0, int(mbp * 1e6) - 60_000, k))
        starts.append(s)
        stops.append(s + rng.integers(5_000, 60_001, k))
    return GeneOrder(names=tuple(f"g{i}" for i in range(G)),
                     chr_names=tuple(f"chr{i + 1}" for i in range(22)),
                     chr_ids=np.repeat(np.arange(22), n).astype(np.int32),
                     start=np.concatenate(starts), stop=np.concatenate(stops))


def bench_hmm():
    import numpy as np

    from infercnv_tpu_torch.models.hmm import HMMParams

    return HMMParams(means=np.array(BENCH_MEANS), sds=np.array(BENCH_SDS), t=1e-6)


def make_counts(lam, gen):
    """Poisson counts as u16 (drawn on the card; every value < 2^15)."""
    import torch

    c = torch.poisson(lam, generator=gen)
    return c.clamp_(max=32767).to(torch.int16).view(torch.uint16)


def make_inputs(dev, go=None, chunk: int = 0, **config):
    """A path's workload, made from SEED on the card: a genome (bench.py's
    by default) and bench.py's HMM, an engine (the default configuration,
    denoise on, sd amplifier 1.5, updated by config), two u16 count chunks
    with the planted loss (chr2) and gain (chr5) in subclusters N_SUB/2..,
    the reference cells in 2 groups, the subcluster membership, and the
    reference statistics with the residual kernel's four bound rows.
    chunk: cells a chunk (CHUNK by default)."""
    import types

    import numpy as np
    import torch

    from infercnv_tpu_torch.ops.residual_fused import counts_to_f32
    from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig

    go = bench_genome() if go is None else go
    chunk = chunk or CHUNK
    G = go.num_genes
    hmm = bench_hmm()
    config = EngineConfig(**{"denoise": True, "sd_amplifier": 1.5, **config})
    engine = CnvEngine(go, hmm, config, device=dev)
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gene_means = torch.tensor(rng.gamma(2.0, 30.0, G), dtype=torch.float32,
                              device=dev)
    labels = torch.arange(chunk, device=dev) % N_SUB
    lam = gene_means[None, :].repeat(chunk, 1)
    tumour = labels >= N_SUB // 2
    genes = torch.arange(G, device=dev)
    for name, fold in (("chr2", 0.5), ("chr5", 2.0)):
        idx = torch.as_tensor(go.chr_gene_indices(name), device=dev)
        lam[tumour[:, None] & torch.isin(genes, idx)[None, :]] *= fold
    counts_a = make_counts(lam, gen)
    counts_b = make_counts(lam, gen)
    del lam
    ref_counts = torch.poisson(gene_means[None, :].repeat(N_REF, 1),
                               generator=gen)
    nf = float(np.median(counts_to_f32(counts_a).sum(dim=1).cpu().numpy()))
    onehot_ref = torch.zeros((2, N_REF), device=dev)
    onehot_ref[0, :N_REF // 2] = 1
    onehot_ref[1, N_REF // 2:] = 1
    onehot = torch.zeros((N_SUB, chunk), device=dev)
    onehot[labels, torch.arange(chunk, device=dev)] = 1
    ml, mr, noise = engine.ref_stats(ref_counts, nf, onehot_ref)
    bounds = [ml.amin(0).contiguous(), ml.amax(0).contiguous(),
              mr.amin(0).contiguous(), mr.amax(0).contiguous()]
    torch.cuda.synchronize()
    return types.SimpleNamespace(
        go=go, hmm=hmm, config=config, engine=engine, gen=gen, counts_a=counts_a,
        counts_b=counts_b, ref_counts=ref_counts, nf=nf,
        onehot_ref=onehot_ref, onehot=onehot, ml=ml, mr=mr, noise=noise,
        bounds=bounds)


def counters():
    """Each kernel's launch count: (module, attribute) of its wrapper."""
    from infercnv_tpu_torch.ops import (
        median, ref_stats, residual_fused, smoothing, viterbi_kernel)

    return {"residual_fused": (residual_fused, "LAUNCHES"),
            "residual_fused_bf16": (residual_fused, "LAUNCHES_BF16"),
            "ref_centred": (residual_fused, "LAUNCHES_CENTRED"),
            "log_norm": (ref_stats, "LAUNCHES_LOG_NORM"),
            "noise_rows": (ref_stats, "LAUNCHES_NOISE_ROWS"),
            "viterbi": (viterbi_kernel, "LAUNCHES"),
            "smooth_banded": (smoothing, "LAUNCHES"),
            "smooth_banded_bf16": (smoothing, "LAUNCHES_BF16"),
            "smooth_general": (smoothing, "LAUNCHES_GENERAL"),
            "median_center_residual": (median, "LAUNCHES_EPILOGUE"),
            "row_median": (median, "LAUNCHES")}


def reset_launches():
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in counters().items()}


#: for each kernel of the table: its source, the TPU kernel it replaces, and
#: the path phase whose launch count it reports
KERNELS = {
    "residual_fused": ("infercnv_tpu_torch/csrc/residual_fused.cu",
                       "infercnv_tpu/ops/residual_fused.py:95", "main_path"),
    "residual_fused_bf16": ("infercnv_tpu_torch/csrc/residual_fused.cu",
                            "infercnv_tpu/ops/residual_fused.py:95", "bf16_path"),
    "viterbi": ("infercnv_tpu_torch/csrc/viterbi.cu",
                "infercnv_tpu/ops/viterbi_pallas.py:77", "main_path"),
    "smooth_banded": ("infercnv_tpu_torch/csrc/smooth_banded.cu",
                      "infercnv_tpu/ops/smoothing.py:74", "main_path"),
    "smooth_banded_bf16": ("infercnv_tpu_torch/csrc/smooth_banded.cu",
                           "infercnv_tpu/ops/smoothing.py:84", "bf16_path"),
    "smooth_general": ("infercnv_tpu_torch/csrc/smooth_general.cu",
                       "infercnv_tpu/ops/smoothing.py:97", "coords_i3_path"),
    "median_center_residual": ("infercnv_tpu_torch/csrc/median.cu",
                               "infercnv_tpu/ops/median.py:109",
                               "wide_genome_path"),
    "row_median": ("infercnv_tpu_torch/csrc/median.cu",
                   "infercnv_tpu/ops/median.py:95", "coords_i3_path"),
    "log_norm": ("infercnv_tpu_torch/csrc/ref_stats.cu",
                 "none (XLA fuses engine.py _ref_stats)", "main_path"),
    "ref_centred": ("infercnv_tpu_torch/csrc/residual_fused.cu",
                    "none (XLA fuses engine.py _ref_stats)", "main_path"),
    "noise_rows": ("infercnv_tpu_torch/csrc/ref_stats.cu",
                   "none (XLA fuses engine.py _ref_stats)", "main_path"),
}


def called(states, go, half: int, neutral: int) -> dict:
    """Fractions of the planted CNV calls: a state below neutral on chr2 and
    above it on chr5 in the tumour subclusters (rows half..; i6 or i3), the
    neutral state in the others, and each tumour subcluster's lowest
    fraction."""
    st = states.cpu().numpy()
    c2, c5 = go.chr_gene_indices("chr2"), go.chr_gene_indices("chr5")
    lo, hi = st[half:][:, c2] < neutral, st[half:][:, c5] > neutral
    return {"del_chr2": float(lo.mean()), "amp_chr5": float(hi.mean()),
            "neutral_0_7": float((st[:half] == neutral).mean()),
            "per_subcluster_min": {"del_chr2": float(lo.mean(axis=1).min()),
                                   "amp_chr5": float(hi.mean(axis=1).min())}}


def require_calls(c: dict, what: str):
    require(c["del_chr2"] > 0.7 and c["amp_chr5"] > 0.7 and c["neutral_0_7"] > 0.9,
            f"{what}: planted CNVs not called: {c}")


def make_run_object(go, n_obs: int, n_ref: int):
    """An InferCNV object from a [G, C] counts matrix made from SEED with
    numpy, through create_infercnv_object: gene means gamma(2, 30) as
    make_inputs draws them, 8 observation groups of n_obs cells (obs4-obs7
    with chr2 at 0.5x and chr5 at 2x) and 2 reference groups of n_ref.
    Returns (object, seconds to make it)."""
    import numpy as np

    from infercnv_tpu_torch.core.object import create_infercnv_object

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    G = go.num_genes
    means = rng.gamma(2.0, 30.0, G)
    cnv = means.copy()
    cnv[go.chr_gene_indices("chr2")] *= 0.5
    cnv[go.chr_gene_indices("chr5")] *= 2.0
    groups = [(f"obs{k}", n_obs) for k in range(8)] + [(f"ref{k}", n_ref)
                                                      for k in range(2)]
    C = sum(n for _, n in groups)
    counts = np.empty((G, C), np.float64)
    cells, ann = [], {}
    c0 = 0
    for name, n in groups:
        lam = cnv if name in ("obs4", "obs5", "obs6", "obs7") else means
        counts[:, c0:c0 + n] = rng.poisson(lam[:, None], size=(G, n))
        for i in range(c0, c0 + n):
            cells.append(f"c{i}")
            ann[f"c{i}"] = name
        c0 += n
    table = {go.names[i]: (go.chr_names[go.chr_ids[i]], int(go.start[i]) + 1,
                           int(go.stop[i]) + 1) for i in range(G)}
    obj = create_infercnv_object(counts, list(go.names), cells, ann, table,
                                 list(go.chr_names), ref_group_names=["ref0", "ref1"])
    return obj, time.perf_counter() - t0


def run_calls(res, neutral: int) -> dict:
    """The planted calls of a run() result: over the cells of obs4-obs7 the
    fraction of (cell, gene) pairs below neutral on chr2 and above it on
    chr5, each subcluster's lowest such fraction, the neutral fraction over
    obs0-obs3 and the references, and, from the pred_cnv_regions report,
    the subclusters of obs4-obs7 with no chr2 loss or no chr5 gain region."""
    import numpy as np

    obj = res.infercnv_obj
    st = res.hmm_states
    go = obj.gene_order
    c2, c5 = go.chr_gene_indices("chr2"), go.chr_gene_indices("chr5")
    tumour = np.concatenate([obj.obs_groups[f"obs{k}"] for k in range(4, 8)])
    normal = np.concatenate([obj.obs_groups[f"obs{k}"] for k in range(4)]
                            + list(obj.ref_groups.values()))
    subs = {n: idx for k in range(4, 8)
            for n, idx in obj.tumor_subclusters["subclusters"][f"obs{k}"].items()}
    per_sub = {n: ((st[idx][:, c2] < neutral).mean(), (st[idx][:, c5] > neutral).mean())
               for n, idx in subs.items()}
    return {"del_chr2": float((st[tumour][:, c2] < neutral).mean()),
            "amp_chr5": float((st[tumour][:, c5] > neutral).mean()),
            "neutral_obs0_3_refs": float((st[normal] == neutral).mean()),
            "subclusters_obs4_7": len(subs),
            "per_subcluster_min": {"del_chr2": float(min(v[0] for v in per_sub.values())),
                                   "amp_chr5": float(min(v[1] for v in per_sub.values()))}}


def report_regions(out_dir: Path, neutral: int, prefix: str = "17_HMM_pred") -> dict:
    """{group: {(chr, "loss" | "gain")}} of a run's pred_cnv_regions report
    (step 17's, or with prefix "HMM_CNV_predictions" the filtered one of
    step 19)."""
    path = next(Path(out_dir).glob(f"{prefix}*.pred_cnv_regions.dat"))
    found: dict = {}
    for line in path.read_text().splitlines()[1:]:
        group, _name, state, chrom = line.split("\t")[:4]
        found.setdefault(group, set()).add(
            (chrom, "loss" if int(state) < neutral else "gain"))
    return found


def denoised_agree(got, want, tol: float = RESID_TOL, f16: bool = False):
    """Whether two runs' final (denoised) expr agree within rtol = atol =
    tol (with f16, the chunks downloaded as float16: within one float16
    ulp, 2^-10 |want|), except where a value sat within tol of the denoise
    band's edge, so that one run moved it to the band's centre and the other
    kept it: there one side is its run's centre (the value denoise writes,
    the most frequent one) and the other lies within 2 tol of the band's
    edge (the nearest kept value).  Returns (ok, max error elsewhere, such
    places)."""
    import numpy as np

    def within(a):
        return 2.0 ** -10 * np.abs(a) if f16 else tol + tol * np.abs(a)

    close = np.abs(got - want) <= within(want)
    centres = []
    for a in (got, want):
        vals, counts = np.unique(a, return_counts=True)
        c = vals[counts.argmax()]
        centres.append((c, float(np.abs(a[a != c] - c).min())))
    (cg, eg), (cw, ew) = centres
    at_g, at_w = ~close & (got == cg), ~close & (want == cw)
    flip = ((at_g & (np.abs(np.abs(want - cw) - ew) <= 2 * within(want)))
            | (at_w & (np.abs(np.abs(got - cg) - eg) <= 2 * within(got))))
    rest = ~close & ~flip
    err = float(np.abs(got - want)[~flip].max())
    return not rest.any(), err, int(flip.sum())


def drive_run(obj, out_dir: Path, dev, **kw):
    """run() on the port with the launch counts set to 0 just before it;
    returns (result, wall seconds, launches)."""
    import torch

    from infercnv_tpu_torch.runner.pipeline import run as run_pipeline

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = run_pipeline(obj, out_dir=str(out_dir), device=dev, **{**RUN_KW, **kw})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, read_launches()


def leiden_calls(res, neutral: int = 3) -> dict:
    """The Leiden run's gates, read from its result: the share of the
    planted loss (chr2) and gain (chr5) called over the cells of obs4-obs7,
    the neutral share over obs0-obs3 and the references, and for each
    subcluster of at least 20 cells its share of cells from one side
    (obs4-obs7 against obs0-obs3; the references form groups of their
    own), with the lowest such share."""
    import numpy as np

    obj = res.infercnv_obj
    st = res.hmm_states
    go = obj.gene_order
    c2, c5 = go.chr_gene_indices("chr2"), go.chr_gene_indices("chr5")
    tumour = np.concatenate([obj.obs_groups[f"obs{k}"] for k in range(4, 8)])
    normal = np.concatenate([obj.obs_groups[f"obs{k}"] for k in range(4)]
                            + list(obj.ref_groups.values()))
    is_tumour = np.zeros(obj.num_cells, bool)
    is_tumour[tumour] = True
    purity = {}
    for subs in obj.tumor_subclusters["subclusters"].values():
        for name, idx in subs.items():
            if len(idx) >= 20:
                f = float(is_tumour[idx].mean())
                purity[name] = max(f, 1.0 - f)
    sizes = sorted((len(i) for subs in obj.tumor_subclusters["subclusters"].values()
                    for i in subs.values()), reverse=True)
    return {"del_chr2": float((st[tumour][:, c2] < neutral).mean()),
            "amp_chr5": float((st[tumour][:, c5] > neutral).mean()),
            "neutral_obs0_3_refs": float((st[normal] == neutral).mean()),
            "subclusters": len(sizes), "largest": sizes[:8],
            "subclusters_of_20_or_more": len(purity),
            "min_one_side_share": min(purity.values()) if purity else None}


class Step15Log:
    """Records, in order, each VST feature selection (its rows and the
    chosen columns) and each kNN (its rows and the neighbours) that step 15
    makes (pca.variable_features_vst and partition.knn_indices wrapped), so
    that two runs whose partitions differ can be checked for near-ties
    (without `record`, the rows are not kept); also the genes the first
    z-score filter kept; with `capture`, a copy of the object and the
    arguments that run() hands to step 15 (its input: the step-14
    residual)."""

    def __init__(self, capture: bool = False, record: bool = True):
        from infercnv_tpu_torch.runner import pipeline
        from infercnv_tpu_torch.subcluster import partition, pca

        self.partition, self.pca, self.pipeline = partition, pca, pipeline
        self.orig = (pca.variable_features_vst, partition.knn_indices,
                     pipeline.define_tumor_subclusters, partition.zscore_gene_filter)
        self.events = []
        self.capture, self.record = capture, record
        self.inputs = None     # (object with its expr copied, kwargs) of run()'s first call
        self.keep = None       # genes kept by the first z-score filter

    @staticmethod
    def _host(x):
        import numpy as np

        return (x.detach().cpu().double().numpy() if hasattr(x, "detach")
                else np.asarray(x, np.float64))

    def __enter__(self):
        vst, knn, define, zfilter = self.orig

        def define_wrapped(obj, **k):
            if self.capture and self.inputs is None:
                o = obj.shallow_copy()
                o.expr = obj.expr.copy()
                self.inputs = (o, {n: v for n, v in k.items()
                                   if n not in ("device", "device_chunks")})
            return define(obj, **k)

        def z_wrapped(*a, **k):
            keep = zfilter(*a, **k)
            if self.keep is None:
                self.keep = keep
            return keep

        def vst_wrapped(x, *a, **k):
            idx = vst(x, *a, **k)
            self.events.append(("vst", self._host(x) if self.record else None, idx))
            return idx

        def knn_wrapped(x, k, device=None):
            nn = knn(x, k, device)
            self.events.append(("knn", self._host(x) if self.record else None,
                                nn.cpu().numpy()))
            return nn

        self.pca.variable_features_vst = vst_wrapped
        self.partition.knn_indices = knn_wrapped
        self.pipeline.define_tumor_subclusters = define_wrapped
        self.partition.zscore_gene_filter = z_wrapped
        return self

    def __exit__(self, *exc):
        (self.pca.variable_features_vst, self.partition.knn_indices,
         self.pipeline.define_tumor_subclusters,
         self.partition.zscore_gene_filter) = self.orig

    def vst_counts(self, go) -> dict:
        """The first VST selection's features in all, and on chr2 and chr5
        of gene order `go`."""
        import numpy as np

        idx = next((e[2] for e in self.events if e[0] == "vst"), None)
        if self.keep is None or idx is None:
            return {}
        genes = self.keep[idx]
        return {"features": int(genes.size), "genes_kept": int(self.keep.size),
                "chr2": int(np.isin(genes, go.chr_gene_indices("chr2")).sum()),
                "chr5": int(np.isin(genes, go.chr_gene_indices("chr5")).sum())}


#: a near-tie: a VST feature whose standardised variance is within
#: VST_TIE_REL of the cutoff's; a kNN entry of an embedding whose distance is
#: within KNN_TIE_REL of the k-th neighbour's; a kNN entry of raw rows
#: within the f32 Gram form's rounding bound, 2 G 2^-24 (|q|^2 + |j|^2)
#: doubled (|a|^2 + |b|^2 - 2 a.b cancels where rows sit near 1)
VST_TIE_REL = 1e-5
KNN_TIE_REL = 1e-5


def near_ties(log_a: "Step15Log", log_b: "Step15Log") -> dict:
    """Where two runs of step 15 on the same input differ, and whether each
    difference is a near-tie (distances and variances from run a's values,
    float64).  After a VST feature set that differs the two embeddings
    differ, so the kNN that follows is not compared entry by entry."""
    import numpy as np

    from infercnv_tpu_torch.subcluster.pca import vst_standardized_variance

    ea, eb = log_a.events, log_b.events
    if [e[0] for e in ea] != [e[0] for e in eb]:
        return {"same_calls": False, "all_near_ties": False}
    vst_diffs, knn_diffs, all_ties, features_differ = [], [], True, False
    for ci, ((kind, xa, ra), (_k, _xb, rb)) in enumerate(zip(ea, eb)):
        if kind == "vst":
            extra = np.setxor1d(ra, rb)
            features_differ = extra.size > 0
            if features_differ:
                sv = vst_standardized_variance(xa)
                cut = np.sort(sv)[::-1][ra.size - 1]
                for g in extra:
                    tie = abs(sv[g] - cut) <= VST_TIE_REL * abs(cut)
                    all_ties &= bool(tie)
                    vst_diffs.append({"call": ci, "gene": int(g), "std_var": float(sv[g]),
                                      "cutoff": float(cut), "near_tie": bool(tie)})
            continue
        embedding = xa.shape[1] <= 10
        if features_differ:
            features_differ = False
            continue
        sq = (xa * xa).sum(axis=1)
        for q in np.nonzero((np.sort(ra, 1) != np.sort(rb, 1)).any(axis=1))[0]:
            d = ((xa - xa[q]) ** 2).sum(axis=1)
            kth = ra[q][np.argmax(d[ra[q]])]
            for j in set(ra[q].tolist()) ^ set(rb[q].tolist()):
                bound = (KNN_TIE_REL * d[kth] if embedding else
                         2 * (2 * xa.shape[1] * 2.0 ** -24 * (sq[q] + max(sq[j], sq[kth]))))
                tie = abs(d[j] - d[kth]) <= bound
                all_ties &= bool(tie)
                knn_diffs.append({"call": ci, "row": int(q), "col": int(j),
                                  "d2": float(d[j]), "kth_d2": float(d[kth]),
                                  "embedding": embedding, "near_tie": bool(tie)})
    return {"same_calls": True, "all_near_ties": bool(all_ties),
            "vst_entries": vst_diffs[:12], "n_vst_entries": len(vst_diffs),
            "knn_entries": knn_diffs[:12], "n_knn_entries": len(knn_diffs)}


def nested_equal(a, b) -> bool:
    """Two {group: {name: cell indices}} maps (or None) are equal, names and
    order included."""
    import numpy as np

    if a is None or b is None:
        return a is b
    return list(a) == list(b) and all(
        list(a[g]) == list(b[g]) and all(np.array_equal(a[g][n], b[g][n]) for n in a[g])
        for g in a)


def replay_step15(inputs, dev) -> dict:
    """Step 15 of one run replayed from that run's own input on the card and
    on the CPU: partitions equal, or every difference a near-tie."""
    from infercnv_tpu_torch.subcluster.partition import define_tumor_subclusters

    obj, kw = inputs
    out = []
    for d in (dev, "cpu"):
        o = obj.shallow_copy()
        with Step15Log() as log:
            per_chr = define_tumor_subclusters(o, device=d, **kw)
        out.append((log, o.tumor_subclusters["subclusters"], per_chr))
    (lg, sg, pg), (lc, sc, pc) = out
    same = nested_equal(sg, sc) and nested_equal(pg, pc)
    ties = None if same else near_ties(lg, lc)
    return {"partitions_equal": same, "near_ties": ties,
            "ok": same or bool(ties["all_near_ties"])}


@contextlib.contextmanager
def constants_set(constants: dict):
    """Module constants of the port ({module: {name: value}}) set for a
    block, then restored."""
    import importlib

    saved = []
    try:
        for mod_name, values in constants.items():
            mod = importlib.import_module(mod_name)
            for k, v in values.items():
                saved.append((mod, k, getattr(mod, k)))
                setattr(mod, k, v)
        yield
    finally:
        for mod, k, v in reversed(saved):
            setattr(mod, k, v)


def logged_run(obj, out_dir: str, device, kw: dict, constants=None) -> dict:
    """run() under a capturing Step15Log, with the port's module constants
    `constants` set; returns what card_against_cpu compares, as numpy and
    plain containers (and the log's lines and step 15's row source), so
    that a worker process can send it back."""
    sys.path.insert(0, str(ROOT))
    from infercnv_tpu_torch.runner.pipeline import run as run_pipeline
    from infercnv_tpu_torch.subcluster import partition

    with constants_set(constants or {}), Step15Log(capture=True) as log, \
            LogLines() as lines:
        r = run_pipeline(obj, out_dir=out_dir, device=device, **{**RUN_KW, **kw})
    return {"expr": r.infercnv_obj.expr, "states": r.hmm_states,
            "subclusters": r.infercnv_obj.tumor_subclusters["subclusters"],
            "per_chr": r.subclusters_per_chr, "events": log.events,
            "inputs": log.inputs, "log": lines.lines, "rows_from": partition.ROWS_FROM}


def card_against_cpu(obj, out_root: Path, name: str, dev, constants=None,
                     f16: bool = False, **kw) -> dict:
    """run() of one configuration on the card and on the CPU (the CPU run in
    a worker process beside the card run), the port's module constants
    `constants` set in both: subclusters, states and report bytes equal,
    final expr under denoised_agree (with f16, the chunks downloaded as
    float16: within one float16 ulp).  Returns (the comparison, the card
    run's logged_run result).

    Step 15's input differs between the two runs by the engine's rounding
    (kernels against plain versions, within 2e-5), and on groups with no
    structure of their own the VST feature ranking and the kNN have
    near-ties that such differences flip.  So where the two runs' partitions
    differ, step 15 is replayed from the card run's own input on the card
    and on the CPU (replay_step15): that must give equal partitions, or
    differences that are all near-ties (printed); the full runs' states and
    reports are then reported, not required equal."""
    import filecmp
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    dirs = {d: out_root / f"{name}_{d}" for d in ("card", "cpu")}
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu = pool.submit(logged_run, obj, str(dirs["cpu"]), "cpu", kw, constants)
        rg = logged_run(obj, str(dirs["card"]), dev, kw, constants)
        rc = cpu.result()
    same_parts = (nested_equal(rg["subclusters"], rc["subclusters"])
                  and nested_equal(rg["per_chr"], rc["per_chr"]))
    replay = None
    xg, xc = rg["inputs"][0].expr, rc["inputs"][0].expr
    input_err = float(np.abs(xg - xc).max()) if xg.shape == xc.shape else None
    if not same_parts:
        replay = replay_step15(rg["inputs"], dev)
        print(f"chip_smoke: {name}: card and CPU partitions differ (step-15 inputs "
              f"differ by up to {input_err}); step 15 replayed from the card run's "
              f"input: {json.dumps(replay)}", file=sys.stderr, flush=True)
        require(replay["ok"], f"{name}: step 15 on one input differs between the "
                f"card and the CPU beyond near-ties: {replay}")
    same_states = bool(np.array_equal(rg["states"], rc["states"]))
    reports = sorted(p.name for p in dirs["cpu"].glob("17_HMM_pred*"))
    equal = [f for f in reports if filecmp.cmp(dirs["card"] / f, dirs["cpu"] / f,
                                                shallow=False)]
    eg, ec = rg["expr"], rc["expr"]
    shape_ok = eg.shape == ec.shape
    ok, err, flips = denoised_agree(eg, ec, f16=f16) if shape_ok else (False, None, 0)
    if same_parts:
        require(same_states, f"{name}: card and CPU HMM states differ")
        require(len(reports) == 4 and equal == reports,
                f"{name}: region reports differ: {sorted(set(reports) - set(equal))}")
        require(shape_ok and ok, f"{name}: card and CPU final expr differ "
                f"(max {err} away from the denoise band's edge)")
    return dict(cells=int(ec.shape[0]), genes=int(ec.shape[1]),
                step15_input_max_abs_err=input_err, subclusters_equal=same_parts,
                replay=replay, subclusters=sum(len(v) for v in rc["subclusters"].values()),
                states_equal=same_states, reports_byte_equal=equal,
                expr_max_abs_err=err, denoise_edge_flips=flips), rg


def bayes_sampler(dev, smi) -> None:
    """The Bayesian filter's Gibbs sampler on the card: tests/test_bayes_scale.py's
    three cases as gates (the sharp posterior E[theta_1] = 9/11 within 0.05
    with half the slots masked, the masked counts, invariance to extra
    padding within 0.05 with the same argmax), then one block at the size
    of the repository's Bayes workload, timed (reported, not gated): wall
    seconds, ms a sweep, peak memory, kernels a sweep (torch.profiler), and
    the bytes a sweep must move (ll and the mask read, the draws read and
    written as int64, eps_sum read and written) at 3.35 TB/s as its bound."""
    import numpy as np
    import torch

    from infercnv_tpu_torch.models import bayes

    def gibbs(ll, mask, chains, burn, iters, seed=0):
        th, ef, tr = bayes._gibbs_all_regions(
            bayes.block_generator(seed, 0, dev), torch.from_numpy(ll).to(dev),
            torch.from_numpy(mask).to(dev), chains, burn, iters)
        return th.cpu().numpy(), ef.cpu().numpy(), tr.cpu().numpy()

    # sharp posterior, masked counts
    ll = np.zeros((1, 16, 3), np.float32)
    ll[0, :8, 0] = 8.0
    mask = np.zeros((1, 16), np.float32)
    mask[0, :8] = 1.0
    th, ef, _ = gibbs(ll, mask, 3, 50, 300, seed=2)
    sharp = float(th[0, 0])
    require(abs(sharp - 9 / 11) < 0.05, f"bayes_sampler: E[theta_1] {sharp}, not 9/11")
    masked = float(ef[0, :8, 0].mean())
    require(masked > 0.95, f"bayes_sampler: real cells in state 1 {masked} <= 0.95")
    # padding invariance
    rng = np.random.default_rng(1)
    ll = np.zeros((2, 30, 3), np.float32)
    ll[0, :, 0] = 5.0
    ll[1, :, 2] = 5.0
    ll += rng.normal(0, 0.1, ll.shape).astype(np.float32)
    mask = np.ones((2, 30), np.float32)
    mask[1, 20:] = 0.0
    ll *= mask[..., None]
    th1, ef1, _ = gibbs(ll, mask, 3, 50, 200)
    th2, ef2, _ = gibbs(np.concatenate([ll, np.zeros((2, 14, 3), np.float32)], 1),
                        np.concatenate([mask, np.zeros((2, 14), np.float32)], 1), 3, 50, 200)
    pad_err = float(max(np.abs(th1 - th2).max(), np.abs(ef1[0] - ef2[0, :30]).max()))
    require(pad_err < 0.05 and th1.argmax(1).tolist() == th2.argmax(1).tolist() == [0, 2],
            f"bayes_sampler: padding changed the posterior (max {pad_err})")

    # one block at the Bayes workload's size: regions of 3,125 cells whose
    # cells favour one state each (a CNV call) with N(0, 1) noise
    R, C, S, ch = BAYES_R, BAYES_CMAX, 6, bayes.N_CHAINS_I6
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    ll = torch.randn((R, C, S), generator=gen, device=dev)
    ll[torch.arange(R, device=dev), :, torch.arange(R, device=dev) % S] += 3.0
    mask = torch.ones((R, C), device=dev)
    sweeps = bayes.N_BURN + bayes.N_ITER
    per_sweep = None
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            bayes._gibbs_all_regions(bayes.block_generator(SEED, 0, dev), ll, mask,
                                     ch, 2, 3)
            torch.cuda.synchronize()
        n_kernels = sum(e.count for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        per_sweep = n_kernels / 5
    except Exception as e:  # the kernel count is reported, never gated
        print(f"chip_smoke: bayes_sampler: no profile ({e})", file=sys.stderr, flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    th, ef, tr = bayes._gibbs_all_regions(bayes.block_generator(SEED, 0, dev), ll,
                                          mask, ch, bayes.N_BURN, bayes.N_ITER)
    b.record()
    b.synchronize()
    wall = time.perf_counter() - t0
    dev_ms = a.elapsed_time(b)
    peak = torch.cuda.max_memory_allocated() - base
    favoured = (th.argmax(1).cpu() == torch.arange(R) % S).float().mean().item()
    require(bool(torch.isfinite(th).all()) and favoured == 1.0,
            f"bayes_sampler: the block's posterior misses the favoured states ({favoured})")
    sweep_bytes = R * C * (4 * S + 4 + 2 * 8 * ch + 2 * 4 * S)
    bound_ms = sweep_bytes / HBM_BYTES_PER_S * 1e3
    emit(phase="bayes_sampler", card=smi, sharp_theta_1=sharp, masked_real_share=masked,
         padding_max_abs_err=pad_err, regions=R, cells=C, states=S, chains=ch,
         sweeps=sweeps, wall_s=wall, device_ms=dev_ms, ms_per_sweep=dev_ms / sweeps,
         peak_memory_gb=peak / 1e9, kernels_per_sweep=per_sweep,
         bytes_per_sweep=sweep_bytes, bound_ms_per_sweep=bound_ms, bound_by="bytes")
    del ll, mask, th, ef, tr
    torch.cuda.empty_cache()


def bayes_summary(res) -> dict:
    """Step 18's numbers from a run() result: seconds of 18_bayes and its
    parts and of 19_region_reports, regions modelled, removed and
    reassigned, the sampler's sweeps and the largest R-hat."""
    import numpy as np

    from infercnv_tpu_torch.viz.bayes_plots import gelman_rubin

    b = res.bayes_result
    secs = {r["step"]: r["seconds"] for r in res.timer.records
            if r["step"].startswith(("18_bayes", "19_region_reports"))}
    rhat = (float(np.nanmax(gelman_rubin(b.theta_traces)))
            if b is not None and b.theta_traces is not None else None)
    return {"seconds": secs,
            "regions_modelled": len(b.cnv_region_names) if b else 0,
            "removed": len(b.removed_regions) if b else 0,
            "reassigned": len(b.reassigned) if b else 0,
            "sweeps": b.sweeps if b else 0,
            "sampler_ms_per_sweep": (1e3 * b.seconds["sampler"] / b.sweeps
                                     if b and b.sweeps else None),
            "max_rhat": rhat}



def have_matplotlib() -> bool:
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


class LogLines(logging.Handler):
    """Collects the port's log messages of `level` and above while it is
    installed (a with block)."""

    def __init__(self, level=logging.INFO):
        super().__init__(level)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        logging.getLogger("infercnv_tpu_torch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("infercnv_tpu_torch").removeHandler(self)


class PlotWarnings(LogLines):
    """Collects the warnings the port logs while it is entered; `failed`
    lists those that say a plot failed."""

    def __init__(self):
        super().__init__(logging.WARNING)

    @property
    def failed(self):
        return [m for m in self.lines if " failed" in m]


def check_plot_warnings(w: PlotWarnings, mpl: bool, what: str) -> list:
    """With matplotlib, no plot may fail; without it, only at the missing
    module.  Returns the failures."""
    bad = [m for m in w.failed if mpl or "matplotlib" not in m]
    require(not bad, f"{what}: plots failed: {bad[:5]}")
    return w.failed


#: the heatmaps run() draws, by output name (infercnv_tpu/runner/pipeline.py
#: :801-808, :823-846, :936-945, :1019-1030, :1084-1118)
def heatmap_names(hmm_token: str, pnorm: float, subclusters: bool) -> list:
    names = ["infercnv.preliminary", f"infercnv.17_HMM_pred{hmm_token}",
             f"infercnv.20_HMM_pred{hmm_token}.Pnorm_{pnorm:g}.repr_intensities",
             "infercnv"]
    return (["infercnv_subclusters"] if subclusters else []) + names


def expected_plot_files(out_dir: Path, hmm_token: str, pnorm: float, regions: int,
                        subclusters: bool, mpl: bool, diagnostics: bool = False):
    """(files the JAX package writes for the plots of such a run, files
    missing or empty): each heatmap's PNG and its groupings and thresholds
    text, the Bayes probability plots (a page of region bars a 200 regions,
    of cell panels a 64) and the P(normal) heatmap, and with diagnostics
    the MCMC files; the PNGs only where matplotlib renders (the text
    outputs are written before the figure)."""
    files = []
    for n in heatmap_names(hmm_token, pnorm, subclusters):
        files += [f"{n}.observation_groupings.txt", f"{n}.heatmap_thresholds.txt"]
        if mpl:
            files.append(f"{n}.png")
    bayes = f"BayesNetOutput{hmm_token}"
    if mpl:
        files.append("infercnv.NormalProbabilities.PostFiltering.png")
        for stem, per in (("cnvProbs", 200), ("cellProbs", 64)):
            files += [f"{bayes}/{stem}{'' if k == 0 else f'.page{k + 1}'}.png"
                      for k in range(-(-regions // per))]
        if diagnostics:
            files.append(f"{bayes}/MCMC_Diagnostics.png")
    if diagnostics:
        files.append(f"{bayes}/MCMC_Diagnostics.txt")
    missing = [f for f in files if not (out_dir / f).is_file()
               or (out_dir / f).stat().st_size == 0]
    return files, missing


def plot_step_seconds(records) -> dict:
    """Each plot step's seconds, with its data side and render."""
    out = {}
    for r in records:
        step = r["step"]
        base, _, part = step.partition(".")
        if base.endswith(("_plot", "_plots")):
            out.setdefault(base, {})[part or "total"] = r["seconds"]
    return out


def png_blocks(path) -> "np.ndarray":
    """24x24 block means of a PNG's gray levels (tests/test_heatmap_golden.py
    :_render)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.image as mpimg

    gray = mpimg.imread(str(path))[..., :3].mean(axis=2)
    H, W = gray.shape
    bh, bw = H // 24, W // 24
    return gray[:bh * 24, :bw * 24].reshape(24, bh, 24, bw).mean(axis=(1, 3))


#: relative tolerance of the PC1 near-ties (f32 products over 8,448 genes)
PC1_TIE_REL = 1e-4


def heatmap_data_check(obj, dev, smi, name: str, **kw) -> dict:
    """heatmap_data on the card and on the CPU on one object: the centre
    within 1e-6 relative, lo and hi within f32 rounding (two ulps, the
    centre's one included), panes within 1e-6, the linkage orders equal,
    the PC1 orders equal but for near-ties (the card's order sorted by the
    CPU's projections within PC1_TIE_REL of their largest), the histogram
    counts equal.  Returns the summary."""
    import numpy as np
    import torch

    from infercnv_tpu_torch.viz.heatmap import heatmap_data

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    g = heatmap_data(obj, device=dev, **kw)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    t0 = time.perf_counter()
    c = heatmap_data(obj, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    f32 = 2.0 ** -22
    require(abs(g.x_center - c.x_center) <= 1e-6 * abs(c.x_center),
            f"heatmap_data {name}: centre {g.x_center} against {c.x_center}")
    require(abs(g.lo - c.lo) <= f32 * abs(c.lo) and abs(g.hi - c.hi) <= f32 * abs(c.hi),
            f"heatmap_data {name}: range {g.lo, g.hi} against {c.lo, c.hi}")
    pane_err = max(float(np.abs(a - b).max()) if a.size else 0.0 for a, b in
                   [(g.obs_mat, c.obs_mat)] + [(a[0], b[0]) for a, b in
                                               zip(g.ref_mats, c.ref_mats)])
    require(pane_err <= 1e-6, f"heatmap_data {name}: panes differ by {pane_err}")
    require(np.array_equal(g.hist_counts, c.hist_counts),
            f"heatmap_data {name}: histogram counts differ")
    # orders: PC1 blocks (logged with their projections) against near-ties,
    # every other position equal
    pc1_rows = set()
    near, worst = 0, 0.0
    ties = []      # [group, row, card position, CPU projection step there]
    require(set(g.pc1) == set(c.pc1), f"heatmap_data {name}: PC1 blocks differ")
    for key, (sel, pc) in c.pc1.items():
        pg = g.pc1[key][1]
        og, oc = np.argsort(pg, kind="stable"), np.argsort(pc, kind="stable")
        q = pc[og]                     # the CPU's projections in the card's order
        scale = float(np.abs(pc).max())
        drop = float(max(0.0, -np.diff(q).min())) if q.size > 1 else 0.0
        worst = max(worst, drop / max(scale, 1e-30))
        require(drop <= PC1_TIE_REL * scale,
                f"heatmap_data {name}: PC1 order of {key} differs beyond near-ties "
                f"({drop} of {scale})")
        moved = np.nonzero(og != oc)[0]
        near += int(moved.size)
        ties += [[key[0], int(sel[og[k]]), int(k), float(q[k] - q[max(k - 1, 0)])]
                 for k in moved[:20 - len(ties)]]
        pc1_rows.update(int(i) for i in sel)
    def rest(order):
        return np.array([i for i in order if int(i) not in pc1_rows])
    same_linkage = (np.array_equal(rest(g.obs_idx), rest(c.obs_idx))
                    and np.array_equal(rest(g.ref_idx), rest(c.ref_idx))
                    and g.obs_group_sizes == c.obs_group_sizes)
    require(same_linkage, f"heatmap_data {name}: linkage orders differ")
    return dict(card_s=card_s, cpu_s=cpu_s, card_parts=g.seconds, cpu_parts=c.seconds,
                peak_card_gb=peak, held_before_gb=held / 1e9, exact_stats=g.exact_stats,
                x_center={"card": g.x_center, "cpu": c.x_center},
                range={"card": [g.lo, g.hi], "cpu": [c.lo, c.hi]},
                pane_max_abs_err=pane_err, pane_rows=int(g.obs_mat.shape[0]),
                pc1_blocks=len(c.pc1), pc1_positions_differing=near,
                pc1_worst_rel=worst, pc1_near_ties=ties,
                linkage_orders_equal=same_linkage)


def heatmap_data_phase(obj, dev, smi) -> None:
    """The data side on the Leiden run's final object: (a) as run() draws
    it (cluster_by_groups=False, the Leiden subclusters' linkages); (b)
    the preliminary plot of a samples run (eight 4,096-cell groups, each
    ordered by PC1, the references by linkage); and the exact range over
    the whole 294 M-value matrix (the sampled-statistics rule takes rows
    above 200 M values), card against CPU."""
    import numpy as np
    import torch

    from infercnv_tpu_torch.viz.heatmap import expr_mean, get_x_range_auto

    a = heatmap_data_check(obj, dev, smi, "leiden", cluster_by_groups=False)
    plain = obj.shallow_copy()
    plain.tumor_subclusters = None
    b = heatmap_data_check(plain, dev, smi, "groups")
    center = expr_mean(obj.expr, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rg = get_x_range_auto(obj.expr, center, device=dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc = get_x_range_auto(obj.expr, center, device="cpu")
    cpu_s = time.perf_counter() - t0
    require(np.allclose(rg, rc, rtol=2.0 ** -23, atol=0),
            f"heatmap_data: the exact range differs: {rg} against {rc}")
    emit(phase="heatmap_data", card=smi, cells=int(obj.expr.shape[0]),
         genes=int(obj.expr.shape[1]), leiden=a, groups=b,
         exact_range={"card": list(rg), "cpu": list(rc), "values": int(obj.expr.size),
                      "card_s": card_s, "cpu_s": cpu_s})


def warned_run(obj, out_dir: str, device, kw: dict):
    """run() under PlotWarnings, in a worker process: (result, warnings)."""
    sys.path.insert(0, str(ROOT))
    from infercnv_tpu_torch.runner.pipeline import run as run_pipeline

    with PlotWarnings() as warned:
        res = run_pipeline(obj, out_dir=out_dir, device=device, **kw)
    return res, warned.lines


def run_phases(dev, smi, out_root: Path) -> dict:
    """The run() phases and the scale programs; returns each full-width
    phase's launches."""
    # run_scale and the scale programs run beside the host-bound phases
    # below, one process after another, and are waited for at the end
    programs = ProgramPhases(out_root).start()
    try:
        return _run_phases(dev, smi, out_root, programs)
    finally:
        programs.stop()


def _run_phases(dev, smi, out_root: Path, programs: "ProgramPhases") -> dict:
    import filecmp
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from infercnv_tpu_torch.io.rds import read_rds_infercnv
    from infercnv_tpu_torch.runner.pipeline import run as run_pipeline

    launches = {}
    mpl = have_matplotlib()
    if mpl:
        import matplotlib

        emit(phase="plots", render=f"matplotlib {matplotlib.__version__}")
    else:
        emit(phase="plots", render="matplotlib not installed")
    # ---- run_i6_subclusters: i6, qnorm subclusters, bench genome --------
    go = bench_genome()
    obj, make_s = make_run_object(go, RUN_OBS, RUN_REF)
    res, wall, n = drive_run(obj, out_root / "run_i6_subclusters", dev, HMM=True,
                             HMM_type="i6", analysis_mode="subclusters",
                             tumor_subcluster_partition_method="qnorm",
                             BayesMaxPNormal=0.5)
    launches["run_i6_subclusters"] = n
    for k in ("residual_fused", "viterbi", "smooth_banded", "row_median"):
        require(n[k] > 0, f"{k} was not launched by run_i6_subclusters")
    C, G = res.infercnv_obj.expr.shape
    require(bool(np.isfinite(res.infercnv_obj.expr).all()),
            "run_i6_subclusters: the final expr is not finite")
    # the planted calls on the states the Bayesian filter left (step 19)
    require(res.bayes_result is not None, "run_i6_subclusters: step 18 did not run")
    calls = run_calls(res, neutral=3)
    sub = calls["per_subcluster_min"]
    require(sub["del_chr2"] > 0.7 and sub["amp_chr5"] > 0.7
            and calls["neutral_obs0_3_refs"] > 0.9,
            f"run_i6_subclusters: planted CNVs not called: {calls}")
    for prefix in ("17_HMM_pred", "HMM_CNV_predictions"):
        regions = report_regions(out_root / "run_i6_subclusters", 3, prefix)
        missing = [s for k in range(4, 8)
                   for s in res.infercnv_obj.tumor_subclusters["subclusters"][f"obs{k}"]
                   if not {("chr2", "loss"), ("chr5", "gain")} <= regions.get(s, set())]
        require(not missing, f"run_i6_subclusters: no chr2 loss / chr5 gain region "
                f"in the {prefix} report for {missing[:5]}")
    emit(phase="run_i6_subclusters", card=smi, cells=C, genes=G, launches=n,
         make_object_s=make_s, wall_s=wall, step_seconds=res.timer.records,
         called=calls, bayes=bayes_summary(res))
    # ---- mesh_stats: the sharded statistics over this object and run ----
    mesh_stats_phase(obj, res.infercnv_obj.expr, dev, smi)
    del res

    # ---- run_i6_leiden: the default Leiden partition, one 32,768-cell ----
    # group (cluster_by_groups=False), the residual kept on the card, the
    # plots at the reference's defaults
    from infercnv_tpu_torch.subcluster import partition

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    partition.ROWS_FROM = None
    with Step15Log(capture=True, record=False) as step15, PlotWarnings() as warned:
        res, wall, n = drive_run(obj, out_root / "run_i6_leiden", dev, HMM=True,
                                 HMM_type="i6", analysis_mode="subclusters",
                                 cluster_by_groups=False, BayesMaxPNormal=0.5,
                                 no_plot=False)
    engine_residual = step15.inputs[0].expr   # the engine's step-14 residual
    launches["run_i6_leiden"] = n
    for k in ("residual_fused", "viterbi", "smooth_banded", "row_median"):
        require(n[k] > 0, f"{k} was not launched by run_i6_leiden")
    require(partition.ROWS_FROM == "device_chunks",
            f"run_i6_leiden: step 15 took its rows from {partition.ROWS_FROM!r}, "
            "not from the residual kept on the card")
    phases15 = {r["step"]: r["seconds"] for r in res.timer.records
                if r["step"].startswith("15_subclusters")}
    require({f"15_subclusters.{p}" for p in ("gene_filter", "slice", "pca", "knn",
                                             "snn", "leiden", "linkage")} <= set(phases15),
            f"run_i6_leiden: step 15's phases are {sorted(phases15)}")
    require(bool(np.isfinite(res.infercnv_obj.expr).all()),
            "run_i6_leiden: the final expr is not finite")
    calls = leiden_calls(res)
    vst_counts = step15.vst_counts(res.infercnv_obj.gene_order)
    del step15
    subs_obs = res.infercnv_obj.tumor_subclusters["subclusters"]["all_observations"]
    require(len(subs_obs) >= 2, "run_i6_leiden: the 32,768 observation cells "
            f"form {len(subs_obs)} subcluster(s)")
    # The planted CNVs span whole chromosomes, so their genes' residual
    # means sit at 0.75 (chr2) and 1.5 (chr5) beside ~1 elsewhere, and the
    # VST trend (log variance on log mean) fits their variance away: the
    # 2,000 features hold almost none of them, the embedding does not
    # separate the sides, and neither does the JAX package's on this
    # object (tests/test_torch_pipeline_ops.py holds the two packages'
    # Leiden runs equal on subclones with CNV segments).  The side purity
    # and the planted calls are reported, not enforced; `vst_features`
    # counts the chosen genes on chr2 and chr5.
    sides_met = (calls["min_one_side_share"] is not None
                 and calls["min_one_side_share"] >= 0.95)
    calls_met = (calls["del_chr2"] > 0.7 and calls["amp_chr5"] > 0.7
                 and calls["neutral_obs0_3_refs"] > 0.9)
    if not (sides_met and calls_met):
        print(f"chip_smoke: run_i6_leiden: side purity >= 0.95 {sides_met}, planted "
              f"calls {calls_met} (reported, not enforced): {json.dumps(calls)}; "
              f"VST features {json.dumps(vst_counts)}", file=sys.stderr, flush=True)
    C, G = res.infercnv_obj.expr.shape
    # the plots: every file there and none failed (without matplotlib,
    # each fails at its render: the PNGs and their gates are not run)
    plot_failures = check_plot_warnings(warned, mpl, "run_i6_leiden")
    regions = len(res.bayes_result.cnv_region_names) if res.bayes_result else 0
    files, missing = expected_plot_files(
        out_root / "run_i6_leiden", ".HMMi6.hmm_mode-subclusters", 0.5, regions,
        subclusters=True, mpl=mpl)
    require(not missing, f"run_i6_leiden: plot files missing or empty: {missing[:8]}")
    plots = plot_step_seconds(res.timer.records)
    require({"15_subcluster_plot", "15_prelim_plot", "17_state_plot", "18_bayes_plots",
             "20_proxy_plot", "23_final_plot"} <= set(plots),
            f"run_i6_leiden: plot steps recorded: {sorted(plots)}")
    emit(phase="run_i6_leiden", card=smi, cells=C, genes=G, launches=n,
         wall_s=wall, step_seconds=res.timer.records,
         rows_from=partition.ROWS_FROM,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         called=calls, side_purity_met=sides_met, planted_calls_met=calls_met,
         vst_features=vst_counts, bayes=bayes_summary(res),
         plots={"render": "matplotlib" if mpl else "not run: matplotlib not installed",
                "step_seconds": plots, "files": len(files),
                "failed_at_the_missing_matplotlib": len(plot_failures)})
    # ---- heatmap_data: the data side on this run's final object ----------
    heatmap_data_phase(res.infercnv_obj, dev, smi)
    # the median filter's time on this object, reported by entry_points
    mf_timing = median_filter_timing(res.infercnv_obj, dev)
    del res

    # ---- run_op_by_op: steps 4-14 op by op against the engine's -------
    # residual, as run_i6_leiden handed it to step 15
    torch.cuda.empty_cache()
    res, wall, n = drive_run(obj, out_root / "run_op_by_op", dev,
                             use_engine=False, up_to_step=14)
    launches["run_op_by_op"] = n
    for k in ("smooth_banded", "row_median"):
        require(n[k] > 0, f"{k} was not launched by run_op_by_op")
    ops, eng = res.infercnv_obj.expr, engine_residual
    require(ops.shape == eng.shape, f"run_op_by_op: shapes {ops.shape} and {eng.shape}")
    err = float(np.abs(ops - eng).max())
    close = bool(np.allclose(ops, eng, rtol=2e-4, atol=2e-4))
    require(close, f"run_op_by_op: the op-by-op residual is not within 2e-4 of "
            f"the engine's (max abs {err})")
    emit(phase="run_op_by_op", card=smi, cells=int(ops.shape[0]),
         genes=int(ops.shape[1]), launches=n, wall_s=wall,
         step_seconds=res.timer.records, max_abs_err_vs_engine=err)
    del obj, res, ops, eng, engine_residual

    # ---- run_i3_coords_cells: i3, coordinates smoothing, cells mode -----
    hgo = human_like_genome(8448)
    obj, make_s = make_run_object(hgo, RUN_I3_OBS, RUN_REF)
    # BayesMaxPNormal=0: the i3 filter differs from the i6 one only in mu
    # and tau (host code the tests hold to the reference)
    res, wall, n = drive_run(obj, out_root / "run_i3_coords_cells", dev, HMM=True,
                             HMM_type="i3", smooth_method="coordinates",
                             analysis_mode="cells", BayesMaxPNormal=0)
    launches["run_i3_coords_cells"] = n
    for k in ("smooth_general", "row_median", "viterbi"):
        require(n[k] > 0, f"{k} was not launched by run_i3_coords_cells")
    C, G = res.infercnv_obj.expr.shape
    require(bool(np.isfinite(res.infercnv_obj.expr).all())
            and int(res.hmm_states.max()) <= 3,
            "run_i3_coords_cells: non-finite expr or states beyond i3's")
    calls = run_calls(res, neutral=2)
    require(calls["del_chr2"] > 0.7 and calls["amp_chr5"] > 0.7,
            f"run_i3_coords_cells: planted CNVs not called: {calls}")
    # The i3 model calls single normal cells neutral on about 74% of their
    # genes, and the JAX package does the same on this object (the per-cell
    # smoothed residual runs past mu +- 1.645 sigma for long stretches):
    # the 0.9 neutral threshold is reported, met or missed, not enforced.
    neutral_met = calls["neutral_obs0_3_refs"] > 0.9
    if not neutral_met:
        print("chip_smoke: run_i3_coords_cells: the neutral share of obs0-obs3 "
              f"and the references is {calls['neutral_obs0_3_refs']:.4f}, not "
              "above 0.9 (reported, not enforced)", file=sys.stderr, flush=True)
    emit(phase="run_i3_coords_cells", card=smi, cells=C, genes=G, launches=n,
         make_object_s=make_s, wall_s=wall, step_seconds=res.timer.records,
         called=calls, neutral_above_0_9=neutral_met)
    del obj, res

    # ---- run_reference: 1,024 cells, the card against the CPU, at the ----
    # reference's defaults BayesMaxPNormal=0.5 and save_rds=True; then a
    # second card run() into the card's out_dir resumes
    obj, _ = make_run_object(go, RUN_CHECK_OBS, RUN_CHECK_REF)
    kw = dict(HMM=True, HMM_type="i6", analysis_mode="subclusters",
              tumor_subcluster_partition_method="qnorm", denoise=True,
              no_plot=False, diagnostics=True, BayesMaxPNormal=0.5, save_rds=True)
    dirs = {d: out_root / f"run_reference_{d}" for d in ("card", "cpu")}
    # the CPU run in a worker process beside the card run (each writes its
    # compressed checkpoints on the host)
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool, \
            PlotWarnings() as warned:
        cpu = pool.submit(warned_run, obj, str(dirs["cpu"]), "cpu", kw)
        rg = run_pipeline(obj, out_dir=str(dirs["card"]), device=dev, **kw)
        rc, cpu_warnings = cpu.result()
    warned.lines += cpu_warnings
    plot_failures = check_plot_warnings(warned, mpl, "run_reference")
    eg, ec = rg.infercnv_obj.expr, rc.infercnv_obj.expr
    ok, err, flips = denoised_agree(eg, ec)
    require(ok, f"run_reference: card and CPU final expr differ (max {err} "
            f"away from the denoise band's edge)")
    reports = sorted(p.name for p in dirs["cpu"].glob("17_HMM_pred*")
                     if p.suffix != ".npz")
    equal = [f for f in reports if filecmp.cmp(dirs["card"] / f, dirs["cpu"] / f,
                                                shallow=False)]
    require(len(reports) == 4 and equal == reports,
            f"run_reference: region reports differ: {sorted(set(reports) - set(equal))}")
    # step 18: the same modelled regions (before any removal), posteriors
    # within 0.05 (two generators: Philox on the card, mt19937 on the CPU)
    bg, bc = rg.bayes_result, rc.bayes_result
    require(bg is not None and bc is not None and bg.cnv_region_names
            and bg.cnv_region_names == bc.cnv_region_names,
            "run_reference: the card and the CPU modelled different regions")
    pg, pc = bg.cnv_state_probabilities, bc.cnv_state_probabilities
    prob_err = float(np.abs(pg - pc).max())
    require(prob_err <= 0.05, f"run_reference: state probabilities differ by {prob_err}")
    # the filtered states equal outside the regions whose P(normal) lies
    # within 0.1 of the threshold in either run (two honest samplers may
    # decide those differently)
    near = np.zeros(rc.hmm_states.shape, bool)
    n_near = 0
    for ri, r in enumerate(bc.regions):
        if min(abs(pg[2, ri] - 0.5), abs(pc[2, ri] - 0.5)) <= 0.1:
            near[np.ix_(r["cell_idx"], r["gene_idx"])] = True
            n_near += 1
    differ = rg.hmm_states != rc.hmm_states
    require(not (differ & ~near).any(), "run_reference: card and CPU filtered "
            f"states differ outside the {n_near} region(s) near P(normal) = 0.5")
    # checkpoints: the same files; the final RDS read back
    ckpts = sorted(p.name for p in dirs["cpu"].glob("*.npz"))
    require(ckpts == sorted(p.name for p in dirs["card"].glob("*.npz"))
            and "run.final.infercnv_obj.npz" in ckpts,
            f"run_reference: checkpoint files differ: {ckpts}")
    # the plots: the same files; the groupings byte-equal; the thresholds
    # within the tolerance the two runs' expr is held to (their ranges are
    # order statistics of those matrices); the PNG fingerprints within 0.02
    regions = len(bc.cnv_region_names)
    plot_files, missing = [], []
    for d in ("card", "cpu"):
        plot_files, miss = expected_plot_files(
            dirs[d], ".HMMi6.hmm_mode-subclusters", 0.5, regions, subclusters=True,
            mpl=mpl, diagnostics=True)
        missing += [f"{d}/{m}" for m in miss]
    require(not missing, f"run_reference: plot files missing or empty: {missing[:8]}")
    pngs = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*.png"))
    require(pngs(dirs["card"]) == pngs(dirs["cpu"]),
            "run_reference: the card and the CPU wrote different plot files")
    names = heatmap_names(".HMMi6.hmm_mode-subclusters", 0.5, True)
    for n in names:
        require(filecmp.cmp(dirs["card"] / f"{n}.observation_groupings.txt",
                            dirs["cpu"] / f"{n}.observation_groupings.txt", shallow=False),
                f"run_reference: {n}.observation_groupings.txt differs")
    thr_err = max(float(np.abs(np.loadtxt(dirs["card"] / f"{n}.heatmap_thresholds.txt")
                               - np.loadtxt(dirs["cpu"] / f"{n}.heatmap_thresholds.txt")).max())
                  for n in names)
    require(thr_err <= RESID_TOL * 4, f"run_reference: thresholds differ by {thr_err}")
    png_err = None
    if mpl:
        png_err = max(float(np.abs(png_blocks(dirs["card"] / p)
                                   - png_blocks(dirs["cpu"] / p)).max())
                      for p in pngs(dirs["cpu"]))
        require(png_err <= 0.02, f"run_reference: PNG fingerprints differ by {png_err}")
    back = read_rds_infercnv(str(dirs["card"] / "run.final.infercnv_obj"))
    rds_err = float(np.abs(back.expr - eg).max())
    require(back.expr.shape == eg.shape and rds_err <= 2e-5,
            f"run_reference: run.final.infercnv_obj reads back {rds_err} away")
    # resume: no step 4-14, 17 or 18 again, the same results
    t0 = time.perf_counter()
    rr = run_pipeline(obj, out_dir=str(dirs["card"]), device=dev, **kw)
    resume_s = time.perf_counter() - t0
    steps = [r["step"] for r in rr.timer.records]
    require(not {"17_hmm", "18_bayes", "04-14_engine_transform"} & set(steps),
            f"run_reference: the resumed run recomputed steps: {steps}")
    require(bool(np.array_equal(rr.hmm_states, rg.hmm_states))
            and bool(np.array_equal(rr.infercnv_obj.expr, eg)),
            "run_reference: the resumed run's states or expr differ")
    emit(phase="run_reference", cells=int(eg.shape[0]), expr_max_abs_err=err,
         denoise_edge_flips=flips, reports_byte_equal=equal,
         regions_modelled=len(bg.cnv_region_names), state_prob_max_abs_err=prob_err,
         regions_near_threshold=n_near, filtered_states_equal=not differ.any(),
         removed={"card": len(bg.removed_regions), "cpu": len(bc.removed_regions)},
         checkpoints=ckpts, rds_max_abs_err=rds_err, resumed_steps=steps,
         resume_s=resume_s, bayes_card=bayes_summary(rg),
         plots={"files": len(plot_files), "groupings_byte_equal": len(names),
                "thresholds_max_abs_err": thr_err,
                "png_fingerprint_max_abs_err": (png_err if mpl else
                                                "not run: matplotlib not installed"),
                "failed_at_the_missing_matplotlib": len(plot_failures),
                "step_seconds_card": plot_step_seconds(rg.timer.records)})
    del rg, rc, rr

    # ---- run_subcluster_reference: Leiden per chromosome, and the -------
    # op-by-op options with random_trees, the card against the CPU
    t0 = time.perf_counter()
    a, _ = card_against_cpu(obj, out_root, "run_subcluster_reference_a", dev,
                            HMM=True, HMM_type="i6", analysis_mode="subclusters",
                            cluster_by_groups=True, per_chr_hmm_subclusters=True,
                            BayesMaxPNormal=0)
    a_s = time.perf_counter() - t0
    # (b) on half the cells (8 x 48 + 2 x 64 = 512): random_trees' host
    # recursion took ~100 s a side on 1,024, and the scale programs now
    # share the script's time limit
    half, _ = make_run_object(go, RUN_CHECK_OBS // 2, RUN_CHECK_REF // 2)
    t0 = time.perf_counter()
    b, _ = card_against_cpu(half, out_root, "run_subcluster_reference_b", dev,
                            HMM=True, HMM_type="i6", analysis_mode="subclusters",
                            use_engine=False, num_ref_groups=2,
                            tumor_subcluster_partition_method="random_trees",
                            max_centered_threshold="auto",
                            remove_genes_at_chr_ends=True, prune_outliers=True,
                            mask_nonDE_genes=True, BayesMaxPNormal=0)
    b_s = time.perf_counter() - t0
    emit(phase="run_subcluster_reference", leiden_per_chr=dict(a, seconds=a_s),
         op_by_op_random_trees=dict(b, seconds=b_s, cells=half.num_cells))
    del half
    torch.cuda.empty_cache()

    # ---- scale_reference: the 1M-cell options on these 1,024 cells ------
    scale_reference_phase(obj, dev, out_root)

    # ---- the mesh in run(), several processes, the entry points ---------
    mesh_run_phase(obj, dev, smi, out_root)
    multiprocess_phase(dev, smi, out_root)
    entry_points_phase(obj, dev, smi, out_root, mf_timing)
    del obj
    torch.cuda.empty_cache()
    leiden_fidelity_phase(dev, smi)

    # ---- run_scale (run() at 262,144 cells) and the scale programs, each --
    # in a process of its own beside the phases above
    launches.update(programs.finish(smi))
    return launches


# ---------------------------------------------------------------------------
# the 1M-cell configuration's options: float16 downloads, the residual in a
# disk memmap, lazy per-group slicing, the in-place block denoise
# ---------------------------------------------------------------------------

#: the options of benchmarks/scale1m_run.py:137-144 that change routes
SCALE_OPTIONS = dict(engine_transfer_dtype="float16")
#: the port's constants that switch the last two on above 2e9 elements, and
#: the one that keeps a Leiden step 15's residual on the card, set so that
#: 1,024 cells take every route of the 1M-cell run
SCALE_FORCED = {"infercnv_tpu_torch.subcluster.partition": {"LAZY_SLICE_ELEMENTS": 0},
                "infercnv_tpu_torch.runner.pipeline": {"INPLACE_DENOISE_ELEMENTS": 0,
                                                       "KEEP_RESIDUAL_BYTES": 0}}
#: at most this share of a scale_reference run's values may sit on the
#: denoise band's edge (tests/test_torch_scale_paths.py's bound)
EDGE_SHARE = 1e-3
KERNEL_DIRECT = "engine chunk downloads as float16 (kernel-direct)"
LAZY_SLICE = "lazy per-group slicing"
MEMMAP_NAME = "_residual.f32.memmap"


def scale_reference_phase(obj, dev, out_root: Path) -> None:
    """run() with the 1M-cell configuration's four options on
    run_reference's 1,024 cells, the card against the CPU (a worker
    process): float16 downloads, residual_memmap_gb=1e-9, and lazy slicing
    and the in-place denoise forced in both runs (SCALE_FORCED); the qnorm
    subclusters as run_reference takes them, and the Leiden.  The card's
    final expr within one float16 ulp of the CPU's but at the denoise
    band's edge (counted and bounded), the states equal and the region
    reports byte-equal (card_against_cpu); each route shown taken on the
    card: the memmap file at 4 C G bytes, still the final expr after step
    22, the kernel-direct float16 store, the lazy slice."""
    import numpy as np

    out = {}
    for method in ("qnorm", "leiden"):
        name = f"scale_reference_{method}"
        t0 = time.perf_counter()
        cmp, card = card_against_cpu(
            obj, out_root, name, dev, constants=SCALE_FORCED, f16=True,
            HMM=True, HMM_type="i6", analysis_mode="subclusters",
            tumor_subcluster_partition_method=method, BayesMaxPNormal=0,
            residual_memmap_gb=1e-9, **SCALE_OPTIONS)
        seconds = time.perf_counter() - t0
        expr = card["expr"]
        mm = {d: out_root / f"{name}_{d}" / MEMMAP_NAME for d in ("card", "cpu")}
        sizes = {d: p.stat().st_size if p.exists() else None for d, p in mm.items()}
        require(all(v == 4 * expr.size for v in sizes.values()),
                f"{name}: memmap files {sizes}, not {4 * expr.size} bytes each")
        require(isinstance(expr, np.memmap)
                and Path(expr.filename).resolve() == mm["card"].resolve(),
                f"{name}: the final expr is a {type(expr).__name__}, not the memmap")
        routes = {"kernel_direct_f16": any(KERNEL_DIRECT in m for m in card["log"]),
                  "lazy_slice": any(LAZY_SLICE in m for m in card["log"]),
                  "rows_from": card["rows_from"]}
        require(routes["kernel_direct_f16"] and routes["lazy_slice"]
                and routes["rows_from"] == "host", f"{name}: routes not taken: {routes}")
        require(cmp["denoise_edge_flips"] <= EDGE_SHARE * expr.size,
                f"{name}: {cmp['denoise_edge_flips']} values on the denoise band's edge")
        out[method] = dict(cmp, seconds=seconds, routes=routes, memmap_bytes=sizes["card"])
    emit(phase="scale_reference", **out)


#: run_scale: benchmarks/torch_scale1m_run.py's workload (BASELINE.json
#: config 5) cut from 1M cells to 262,144, the smallest power of two at
#: which run()'s own 2e9-element rules switch on lazy slicing and the
#: in-place denoise (262,144 x ~8,940 genes after the cutoff, 2.34e9), for
#: the script's time limit; residual_memmap_gb 4.0 in place of 20.0, so
#: that its 9.4 GB residual goes to disk as the 1M run's 36 GB one does;
#: no plots (as `--no-plot`)
SCALE_CELLS = 262_144
SCALE_MEMMAP_GB = 4.0
SCALE_TIMEOUT_S = 900
#: run_scale's bound on the resident set at the end of steps 4-14 (the
#: 04-14_engine_transform and 04-14_hspike_mirror records), from the
#: accounting of ROADMAP C5: what the process held just before run()
#: (Python, torch, the CUDA context; the counts are on disk), plus the
#: engine's pinned staging (two float32 buffers in, two float16 out, of
#: SCALE_RUN_CHUNK rows), plus step 2's gene-filtered u16 counts (the run
#: keeps them as obj.counts, as the reference does unless save_final_rds
#: is off), plus this fraction of the residual's bytes for the rest (the
#: CUDA libraries' host memory, the hspike: 3.3 GB of the 16.77 GB measured
#: on an H100 host).  Without the file I/O of utils/memmap.py the line also
#: held the caller's counts and every page of the memmap (4.7 and 9.4 GB
#: here; 30.1 GB in all on the same host), each more than the margin left.
SCALE_RSS_RESIDUAL_FRACTION = 0.5
#: the engine's chunk in run_scale (torch_scale1m_run.SCALE_KW)
SCALE_RUN_CHUNK = 32768
#: run_scale's counts file (as torch_scale1m_run.py --counts_cache writes
#: one), deleted after the run
SCALE_COUNTS_FILE = "_counts.u16.npy"


def scale_program(name: str):
    """benchmarks/<name>.py, the port's scale programs (imported from the
    checkout; they import each other by module name)."""
    import importlib

    bench = str(ROOT / "benchmarks")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    return importlib.import_module(name)


def synth_scale_counts(C: int, dev, path: Path, n_groups: int = 3, seed: int = SEED):
    """torch_scale1m_run.synth_counts_streamed's genome, groups and planted
    CNVs (its gene means from numpy seed `seed`), the Poisson counts drawn
    on the card from a generator seeded with `seed`, a row block at a time
    (2.4e9 numpy draws would take most of a minute), into the .npy file
    `path` and handed back as a read-only disk memmap of it, as
    torch_scale1m_run.counts_from hands run() its counts.  Returns (gene
    order, counts [C, G] u16, reference groups, tumour groups, {tumour
    group: (lost genes, gained genes)})."""
    import numpy as np
    import torch

    from infercnv_tpu_torch.utils.memmap import write_rows

    s100k = scale_program("torch_scale100k_run")
    s1m_run = scale_program("torch_scale1m_run")
    go = s100k.synth_genome()
    G = go.num_genes
    gene_means = np.random.default_rng(seed).gamma(2.0, 8.0, G)
    ref_groups, tumor_groups, planted, factors = s100k.tumour_layout(go, C, n_groups)
    counts = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint16, shape=(C, G))
    bounds = s1m_run.row_bounds(C, n_groups)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for row_grp in range(n_groups + 1):
        lo, hi = bounds[row_grp], bounds[row_grp + 1]
        lam = torch.tensor(gene_means * factors[row_grp], dtype=torch.float32, device=dev)
        for b in range(lo, hi, CHUNK):
            e = min(b + CHUNK, hi)
            block = make_counts(lam[None, :].expand(e - b, G).contiguous(), gen)
            write_rows(counts, b, block.view(torch.int16).cpu().numpy().view(np.uint16))
    del counts
    return go, np.load(path, mmap_mode="r"), ref_groups, tumor_groups, planted


def scale_worker(argv) -> int:
    """run_scale's process: chip_smoke.py --scale-worker DIR [DEVICE] (the
    first card by default).  Makes the counts, runs run() as
    torch_scale1m_run.run_scaled does (the memmap at SCALE_MEMMAP_GB, no
    plots), gates the result with its gates and the routes the options
    take, and writes DIR/result.json; a failed gate exits non-zero."""
    import gc

    import numpy as np
    import torch

    dev = torch.device(argv[1] if len(argv) > 1 else "cuda:0")
    if dev.type == "cuda" and not torch.cuda.is_available():
        return fail("scale worker: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from infercnv_tpu_torch.core.object import InferCNV
    from infercnv_tpu_torch.subcluster import partition

    s1m_run = scale_program("torch_scale1m_run")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = Path(argv[0])
    run_dir = out_dir / "run"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    C = SCALE_CELLS
    G = s1m_run.s100k.GENES
    room = s1m_run.machine_room(run_dir)
    counts_gb, memmap_gb = C * G * 2 / 1e9, C * G * 4 / 1e9
    # the counts, step 2's float32 copy and its gene-filtered counts, and
    # the memmap's pages: a margin of twice the counts and the memmap
    require(room["ram_available_gb"] > 2 * (counts_gb + memmap_gb),
            f"run_scale: this machine cannot hold {counts_gb:.1f} GB of counts plus "
            f"a {memmap_gb:.1f} GB memmap: {room}")
    require(room["disk_free_gb"] > 1.2 * memmap_gb,
            f"run_scale: {room['disk_free_gb']:.1f} GB of free disk cannot hold the "
            f"{memmap_gb:.1f} GB memmap")
    from infercnv_tpu_torch.utils.profiling import memory_gb

    t0 = time.perf_counter()
    go, counts, ref_groups, tumor_groups, planted = synth_scale_counts(
        C, dev, run_dir / SCALE_COUNTS_FILE)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    obj = InferCNV(expr=counts, counts=counts, gene_order=go,
                   cell_names=[f"c{i}" for i in range(C)],
                   ref_groups=ref_groups, obs_groups=tumor_groups)
    del counts
    torch.cuda.empty_cache()
    gc.collect()
    rss_before = memory_gb()
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    partition.ROWS_FROM = None
    with LogLines() as lines:
        res, wall, failed = s1m_run.run_scaled(obj, str(run_dir), dev, no_plot=True,
                                               memmap_gb=SCALE_MEMMAP_GB)
    launches = read_launches()
    del obj
    (run_dir / SCALE_COUNTS_FILE).unlink()
    peak_card = torch.cuda.max_memory_allocated()
    held_after = torch.cuda.memory_allocated()
    final = res.infercnv_obj
    expr = final.expr
    # the routes: the memmap at 4 C G bytes is still the final expr after
    # step 22's in-place denoise, the kernel stored float16, step 15 sliced
    # each group from it; the kernels of the path launched
    mm = run_dir / MEMMAP_NAME
    mm_bytes = mm.stat().st_size if mm.exists() else None
    routes = {"memmap_bytes": mm_bytes,
              "expr_is_the_memmap": (isinstance(expr, np.memmap)
                                     and Path(expr.filename).resolve() == mm.resolve()),
              "kernel_direct_f16": any(KERNEL_DIRECT in m for m in lines.lines),
              "lazy_slice": any(LAZY_SLICE in m for m in lines.lines),
              "rows_from": partition.ROWS_FROM,
              "elements": int(expr.size)}
    # the program's gates (scale1m_run.py:146-174)
    gates = s1m_run.gates(res, str(run_dir), tumor_groups, planted, True, failed)
    step_seconds = res.timer.records
    # the resident set at the end of each step ([timing] lines), and the
    # gate on steps 4-14 (SCALE_RSS_RESIDUAL_FRACTION)
    memory = [[r["step"], r.get("rss_gb"), r.get("anon_gb"), r.get("file_gb"),
               r.get("peak_gb")] for r in step_seconds if "rss_gb" in r]
    G_kept = int(routes["elements"] // C)
    staging_gb = 2 * SCALE_RUN_CHUNK * G_kept * (4 + 2) / 1e9
    kept_counts_gb = 2 * routes["elements"] / 1e9
    rss_bound = (rss_before.get("rss_gb", 0.0) + staging_gb + kept_counts_gb
                 + SCALE_RSS_RESIDUAL_FRACTION * 4 * routes["elements"] / 1e9)
    rss_engine = max(r[1] for r in memory if r[0].startswith("04-14_"))
    del expr, final, res
    gc.collect()
    torch.cuda.synchronize()
    held_after_gc = torch.cuda.memory_allocated()
    # what is left: the smooth's bounded cache of band weights (the hspike
    # mirror's), and PyTorch's own (cuBLAS workspaces)
    from infercnv_tpu_torch.ops import smoothing

    smoothing._WEIGHTS.clear()
    held_without_weights = torch.cuda.memory_allocated()
    result = dict(
        card=nvidia_smi(), cells=C, genes=int(routes["elements"] // C),
        machine=room, make_counts_s=make_s, wall_s=wall,
        step_seconds=step_seconds,
        memory_gb=dict(before_run=rss_before, steps=memory, after_04_14=rss_engine,
                       bound_after_04_14=rss_bound, staging=staging_gb,
                       kept_counts=kept_counts_gb),
        peak_host_rss_gb=s1m_run.s1m.peak_rss_gb(),
        peak_card_gb=peak_card / 1e9,
        card_allocated_gb={"before_run": held_before / 1e9, "after_return": held_after / 1e9,
                           "after_gc": held_after_gc / 1e9,
                           "without_the_smooth_weights_cache": held_without_weights / 1e9,
                           "reserved_after_gc": torch.cuda.memory_reserved() / 1e9},
        launches=launches, routes=routes, gates=gates)
    (out_dir / "result.json").write_text(json.dumps(result))
    require(mm_bytes == 4 * routes["elements"] and routes["expr_is_the_memmap"]
            and routes["kernel_direct_f16"] and routes["lazy_slice"]
            and routes["rows_from"] == "host", f"run_scale: routes not taken: {routes}")
    for k in ("residual_fused", "viterbi", "smooth_banded", "row_median"):
        require(launches[k] > 0, f"run_scale: {k} was not launched")
    require(s1m_run.s100k.gates_passed(gates), f"run_scale: gates failed: {gates}")
    require(rss_engine <= rss_bound,
            f"run_scale: {rss_engine:.2f} GB resident after steps 4-14, above the "
            f"bound of {rss_bound:.2f} GB (before run() {rss_before}, staging "
            f"{staging_gb:.2f} GB, counts kept {kept_counts_gb:.2f} GB)")
    return 0


#: leiden_fidelity: scripts/torch_leiden_fidelity.py at these sizes
FIDELITY_SIZES = (1000, 5000)


def leiden_fidelity_phase(dev, smi) -> None:
    """scripts/torch_leiden_fidelity.py (a port of scripts/leiden_fidelity.py)
    at FIDELITY_SIZES on the card: step 15's Leiden route (PCA and kNN on
    the card, SNN and the native Leiden on the host) on planted subclones;
    at each size the Leiden CPM must be at least the SNN components' and
    the planted partition's."""
    scripts = str(ROOT / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import importlib

    fid = importlib.import_module("torch_leiden_fidelity")
    rows = [fid.measure(n, fid.K_PLANTED, dev) for n in FIDELITY_SIZES]
    emit(phase="leiden_fidelity", card=smi, script="scripts/torch_leiden_fidelity.py",
         sizes=rows)
    for r in rows:
        require(fid.passed(r), f"leiden_fidelity: the CPM assertion failed: {r}")


def scale_result(smi, out_dir: Path, rc, seconds: float) -> dict:
    """run_scale's lines and gates from its worker (scale_worker, run by
    ProgramPhases as the first process of its queue): a line with each
    step's resident set, then the phase's line; returns its launches."""
    result_path = out_dir / "result.json"
    result = json.loads(result_path.read_text()) if result_path.exists() else None
    if rc != 0:
        log = out_dir / "worker.log"
        tail = log.read_text().splitlines()[-30:] if log.exists() else []
        print("\n".join(tail), file=sys.stderr, flush=True)
        if result is not None:
            emit(phase="run_scale", process_s=seconds, **result)
    require(rc == 0 and result is not None, f"run_scale: the worker exited with {rc}")
    (out_dir / "run" / MEMMAP_NAME).unlink(missing_ok=True)
    emit(phase="run_scale_memory", card=smi, columns=["step", "rss_gb", "anon_gb", "file_gb", "peak_gb"],
         **result["memory_gb"])
    emit(phase="run_scale", process_s=seconds, **result)
    return result["launches"]


# ---------------------------------------------------------------------------
# the scale programs: benchmarks/torch_scale1m.py (both modes),
# torch_scale100k.py, torch_bayes100k.py and torch_scale100k_run.py at their
# full sizes, each in a process of its own
# ---------------------------------------------------------------------------

#: phase: (program, its arguments, the kernels it must launch)
PROGRAMS = {
    "scale1m_cells": ("torch_scale1m", ["cells"],
                      ("residual_fused", "viterbi", "ref_centred", "row_median")),
    "scale1m_subclusters": ("torch_scale1m", ["subclusters"],
                            ("residual_fused", "viterbi", "ref_centred", "row_median")),
    "scale100k": ("torch_scale100k", [],
                  ("residual_fused", "viterbi", "ref_centred", "row_median")),
    "bayes100k": ("torch_bayes100k", [], ("smooth_banded", "row_median")),
    "scale100k_run": ("torch_scale100k_run", [],
                      ("residual_fused", "viterbi", "smooth_banded", "row_median")),
}
PROGRAM_TIMEOUT_S = 600


def program_worker(argv) -> int:
    """A program phase's process: chip_smoke.py --program-worker PHASE DIR
    [DEVICE].  Runs the program's main at its full size (its output goes
    to the worker's log), with the launch counts set to 0 just before it;
    writes DIR/result.json: its exit code, its JSON lines and the launches."""
    import contextlib
    import io

    phase, out_dir = argv[0], Path(argv[1])
    name, args, _ = PROGRAMS[phase]
    sys.path.insert(0, str(ROOT))
    prog = scale_program(name)
    if phase == "scale100k_run":
        args = [*args, "--out_dir", str(out_dir / "run")]
    if len(argv) > 2:
        args = [*args, "--device", argv[2]]
    reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = prog.main(args)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    text = out.getvalue()
    print(text, flush=True)
    lines = [json.loads(s[2:] if s.startswith("# {") else s)
             for s in text.splitlines() if s.startswith(("{", "# {"))]
    (out_dir / "result.json").write_text(json.dumps(
        dict(rc=rc, seconds=seconds, lines=lines, launches=launches)))
    return rc


class ProgramPhases:
    """run_scale, then the program phases, one process after another, in a
    thread beside the host-bound run() phases of this process (started by
    start(), waited for by finish(); stop() kills the running process).
    run_scale goes first: it is the longest, and each process's memory is
    its own."""

    def __init__(self, out_root: Path):
        import threading

        self.out_root = out_root
        self.results = {}
        self.proc = None
        self.stopped = False
        self.lock = threading.Lock()   # stop() against the start of a process
        self.thread = threading.Thread(target=self._work, daemon=True)

    def start(self):
        self.thread.start()
        return self

    def _work(self):
        script = str(Path(__file__).resolve())
        for phase in ("run_scale", *PROGRAMS):
            out_dir = self.out_root / phase
            shutil.rmtree(out_dir, ignore_errors=True)
            out_dir.mkdir(parents=True)
            if phase == "run_scale":
                cmd, limit = [sys.executable, script, "--scale-worker", str(out_dir)], SCALE_TIMEOUT_S
            else:
                cmd = [sys.executable, script, "--program-worker", phase, str(out_dir)]
                limit = PROGRAM_TIMEOUT_S
            t0 = time.perf_counter()
            with open(out_dir / "worker.log", "w") as f:
                with self.lock:
                    if self.stopped:
                        return
                    self.proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
                try:
                    rc = self.proc.wait(timeout=limit)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
                    self.proc.wait()
                    rc = f"killed after {limit} s"
            if phase == "run_scale":
                self.results[phase] = (rc, time.perf_counter() - t0, None)
                continue
            path = out_dir / "result.json"
            self.results[phase] = (rc, time.perf_counter() - t0,
                                   json.loads(path.read_text()) if path.exists() else None)

    def stop(self):
        with self.lock:
            self.stopped = True
            proc = self.proc
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        self.thread.join()

    def finish(self, smi) -> dict:
        """Waits for the programs, prints one line a phase (seconds, cells/s,
        peak host RSS, the card's peak memory, the gates, the launches) and
        gates them, then run_scale's (scale_result); returns each phase's
        launches."""
        self.thread.join()
        launches = {}
        for phase, (name, _args, kernels) in PROGRAMS.items():
            rc, process_s, result = self.results[phase]
            if rc != 0 or result is None:
                log = self.out_root / phase / "worker.log"
                tail = log.read_text().splitlines()[-30:] if log.exists() else []
                print(f"chip_smoke: {phase}: exited with {rc}:\n" + "\n".join(tail),
                      file=sys.stderr, flush=True)
            require(result is not None, f"{phase}: the worker exited with {rc}")
            info = {}
            for line in result["lines"]:
                info.update(line)
            emit(phase=phase, card=smi, program=f"benchmarks/{name}.py", rc=rc,
                 process_s=process_s, seconds=info.get("seconds", info.get("wall_s")),
                 cells=info.get("cells"), cells_per_sec=info.get("cells_per_sec"),
                 peak_host_rss_gb=info.get("peak_host_rss_gb"),
                 peak_card_gb=info.get("peak_card_gb"), gates=info.get("gates"),
                 launches=result["launches"],
                 **{k: info[k] for k in ("metric", "value", "unit", "step_timings",
                                         "parts_s", "regions", "subclusters", "n_loss",
                                         "n_gain", "norm_factor") if k in info})
            require(rc == 0, f"{phase}: the program exited with {rc} (its gates: "
                    f"{info.get('gates')})")
            for k in kernels:
                require(result["launches"][k] > 0, f"{phase}: {k} was not launched")
            launches[phase] = result["launches"]
        rc, seconds, _ = self.results["run_scale"]
        launches["run_scale"] = scale_result(smi, self.out_root / "run_scale", rc, seconds)
        return launches


# ---------------------------------------------------------------------------
# the cell mesh and the entry points
# ---------------------------------------------------------------------------

#: cells of the multiprocess phase's counts.npy (engine and run())
MP_CELLS = 4096
#: the median filter is timed on the whole Leiden object when one 4,096-cell
#: group's time predicts at most this many seconds for it
MEDIAN_FILTER_WHOLE_S = 30.0


def mesh_engine_phase(dev, smi, inp) -> None:
    """The main path's engine over CellMesh([dev, dev]): 2 chunks through
    subcluster_chunk, then the group-mean Viterbi, against the unsharded
    engine on the same chunks (residual within RESID_TOL, group sums within
    float32 summation order, states equal), and both timed."""
    import torch

    from infercnv_tpu_torch.parallel.engine import CnvEngine
    from infercnv_tpu_torch.parallel.stats import CellMesh

    mesh = CellMesh([dev, dev])
    me = CnvEngine(inp.go, inp.hmm, inp.config, mesh=mesh)
    chunks = (inp.counts_a, inp.counts_b)

    def stream(engine):
        acc = None
        for c in chunks:
            resid, *acc = engine.subcluster_chunk(c, inp.nf, inp.ml, inp.mr,
                                                  inp.noise, inp.onehot, acc=acc)
        return resid, acc

    stream(me)                                   # warm-up (allocations)
    out = {}
    for name, engine in (("unsharded", inp.engine), ("sharded", me)):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        resid, acc = stream(engine)
        states = engine.viterbi_group_means(acc[0] / acc[1][:, None])
        torch.cuda.synchronize()
        out[name] = (resid, acc, states, time.perf_counter() - t0, read_launches())
    r1, acc1, s1, t1, _ = out["unsharded"]
    rm, accm, sm, tm, launches = out["sharded"]
    require(len(rm.shards) == 2 and all(s.device == dev for s in rm.shards),
            "mesh_engine: the residual is not in two shards on the card")
    err = float((torch.cat(rm.shards) - r1).abs().max())
    sum_err = float(((accm[0] - acc1[0]).abs() / (acc1[0].abs() + 1.0)).max())
    require(float((torch.cat(rm.shards) - r1).abs().sub(RESID_TOL * (1 + r1.abs())).max()) <= 0,
            f"mesh_engine: sharded and unsharded residuals differ by {err}")
    require(sum_err <= 1e-5 and bool(torch.equal(accm[1], acc1[1])),
            f"mesh_engine: group sums differ by {sum_err} (relative)")
    require(bool(torch.equal(sm, s1)), "mesh_engine: group states differ")
    for k in ("residual_fused", "viterbi"):
        require(launches[k] > 0, f"mesh_engine: {k} was not launched")
    cells = len(chunks) * CHUNK
    emit(phase="mesh_engine", card=smi, shards=2, chunks=len(chunks),
         resid_max_abs_err=err, group_sums_max_rel_err=sum_err, states_equal=True,
         cells_per_s={"sharded": cells / tm, "unsharded": cells / t1},
         seconds={"sharded": tm, "unsharded": t1}, launches=launches,
         launches_per_shard={k: v / 2 for k, v in launches.items()})
    del rm, r1


def mesh_stats_phase(obj, resid, dev, smi) -> None:
    """sharded_median / sharded_quantile over the run object's library
    sizes and sharded_group_gene_stats over the run's residual rows on a
    2-shard mesh of the card, against numpy: the median and quantiles
    exact, the means within 1e-6 relative, the variances within 1e-6 of the
    mean square (their float32 formula subtracts two terms of that size)."""
    import numpy as np
    import torch

    from infercnv_tpu_torch.parallel.stats import (
        CellMesh,
        put_cell_sharded,
        sharded_group_gene_stats,
        sharded_median,
        sharded_quantile,
    )

    mesh = CellMesh([dev, dev])
    lib = np.asarray(obj.expr, np.float32).sum(axis=1)
    t0 = time.perf_counter()
    med = float(sharded_median(lib, mesh))
    med_s = time.perf_counter() - t0
    require(med == float(np.median(lib)), f"mesh_stats: median {med} != {np.median(lib)}")
    srt = np.sort(lib)
    quant = {}
    for q in (0.01, 0.99):
        h = (lib.size - 1) * q
        lo = int(np.floor(h))
        want = srt[lo] + np.float32(h - lo) * (srt[min(lo + 1, lib.size - 1)] - srt[lo])
        got = float(sharded_quantile(lib, q, mesh))
        require(got == float(want), f"mesh_stats: quantile {q}: {got} != {want}")
        quant[q] = got
    groups = list(obj.obs_groups.values()) + list(obj.ref_groups.values())
    onehot = np.zeros((len(groups), lib.size), np.float32)
    for k, g in enumerate(groups):
        onehot[k, g] = 1
    x = put_cell_sharded(np.asarray(resid, np.float32), mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mu, sd = sharded_group_gene_stats(x, onehot, mesh)
    torch.cuda.synchronize()
    stats_s = time.perf_counter() - t0
    mu, var = mu.cpu().numpy(), (sd * sd).cpu().numpy()
    mean_err = var_err = 0.0
    for k, g in enumerate(groups):
        sel = np.asarray(resid[g], np.float64)
        m = sel.mean(axis=0)
        mean_err = max(mean_err, float((np.abs(mu[k] - m) / np.abs(m)).max()))
        var_err = max(var_err, float((np.abs(var[k] - sel.var(axis=0, ddof=1))
                                      / (sel * sel).mean(axis=0)).max()))
    require(mean_err <= 1e-6 and var_err <= 1e-6,
            f"mesh_stats: group means off by {mean_err}, variances by {var_err}")
    emit(phase="mesh_stats", card=smi, shards=2, cells=int(lib.size),
         genes=int(resid.shape[1]), groups=len(groups), median=med,
         quantiles={str(q): v for q, v in quant.items()},
         group_mean_max_rel_err=mean_err, group_var_max_err_of_mean_square=var_err,
         seconds={"median": med_s, "group_stats": stats_s})
    del x


def mesh_run_phase(obj, dev, smi, out_root: Path) -> None:
    """run(mesh=CellMesh([dev, dev])) on the 1,024-cell object in
    subcluster and cell mode against the one-device card run: states equal,
    expr within 1e-5."""
    import numpy as np

    from infercnv_tpu_torch.parallel.stats import CellMesh

    out = {}
    for mode in ("subclusters", "cells"):
        kw = dict(HMM=True, HMM_type="i6", analysis_mode=mode, BayesMaxPNormal=0,
                  tumor_subcluster_partition_method="qnorm")
        r1, w1, _ = drive_run(obj, out_root / f"mesh_run_{mode}_one", dev, **kw)
        rm, wm, n = drive_run(obj, out_root / f"mesh_run_{mode}_mesh", dev,
                              mesh=CellMesh([dev, dev]), **kw)
        err = float(np.abs(rm.infercnv_obj.expr - r1.infercnv_obj.expr).max())
        require(bool(np.array_equal(rm.hmm_states, r1.hmm_states)),
                f"mesh_run: {mode}: the mesh's states differ from one device's")
        require(err <= 1e-5, f"mesh_run: {mode}: expr differs by {err}")
        require(n["residual_fused"] > 0 and n["viterbi"] > 0,
                f"mesh_run: {mode}: launches {n}")
        out[mode] = dict(expr_max_abs_err=err, states_equal=True, launches=n,
                         wall_s={"mesh": wm, "one_device": w1})
    emit(phase="mesh_run", card=smi, cells=int(obj.num_cells), shards=2, modes=out)


def _mp_inputs(data_dir: Path):
    """The multiprocess phase's inputs, read alike in every process from
    counts.npy: the bench genome, the counts [C, G] (memory-mapped), the
    reference cells (the first eighth), and the run object (references
    "ref", the rest "obs0" and "obs1", obs1 with the planted loss)."""
    import numpy as np

    from infercnv_tpu_torch.core.object import create_infercnv_object

    go = bench_genome()
    counts = np.load(data_dir / "counts.npy", mmap_mode="r")
    C = counts.shape[0]
    n_ref = C // 8
    cells = [f"c{i}" for i in range(C)]
    ann = {c: ("ref" if i < n_ref else "obs0" if i < C // 2 else "obs1")
           for i, c in enumerate(cells)}
    table = {go.names[i]: (go.chr_names[go.chr_ids[i]], int(go.start[i]) + 1,
                           int(go.stop[i]) + 1) for i in range(go.num_genes)}
    obj = create_infercnv_object(np.asarray(counts).T, list(go.names), cells, ann,
                                 table, list(go.chr_names), ref_group_names=["ref"])
    return go, obj, counts, n_ref


def _mp_compute(dev, data_dir: Path, mesh) -> dict:
    """The multiprocess phase's work in one process (mesh None) or in one
    rank of several: the sharded median of the library sizes, the
    reference group's gene means, the engine's full_chunk, run()."""
    import numpy as np
    import torch

    from infercnv_tpu_torch.io.sharded import global_cell_array, load_counts_shard
    from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig
    from infercnv_tpu_torch.parallel.stats import (
        sharded_group_gene_stats,
        sharded_median,
        to_host,
    )
    from infercnv_tpu_torch.runner.pipeline import run as run_pipeline

    go, obj, counts, n_ref = _mp_inputs(data_dir)
    C = counts.shape[0]
    config = EngineConfig(denoise=True, sd_amplifier=1.5)
    if mesh is None:
        x = np.array(counts)
        nf = float(np.median(x.sum(axis=1)))
        ref = x[:n_ref]
        gmean = ref.astype(np.float64).mean(axis=0).astype(np.float32)
        engine = CnvEngine(go, bench_hmm(), config, device=dev)
    else:
        local, _g, _c, (lo, hi) = load_counts_shard(str(data_dir / "counts.npy"))
        x = global_cell_array(local, mesh, C)
        nf = float(sharded_median(global_cell_array(
            local.sum(axis=1).astype(np.float32), mesh, C), mesh))
        oh = (np.arange(lo, hi) < n_ref).astype(np.float32)[:, None]
        gmean, _sd = sharded_group_gene_stats(x, global_cell_array(oh, mesh, C), mesh)
        gmean = gmean[0].cpu().numpy()
        engine = CnvEngine(go, bench_hmm(), config, mesh=mesh)
        ref = to_host(x)[:n_ref]
    ml, mr, noise = engine.ref_stats(ref, nf)
    resid, states = engine.full_chunk(x, nf, ml, mr, noise)
    resid, states = to_host(resid), to_host(states)
    kw = dict(HMM=True, HMM_type="i6", analysis_mode="subclusters",
              tumor_subcluster_partition_method="qnorm", BayesMaxPNormal=0,
              **RUN_KW)
    name = "one" if mesh is None else f"rank{mesh.rank}"
    res = run_pipeline(obj, out_dir=str(data_dir / f"run_{name}"), device=dev,
                       mesh=mesh, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return dict(nf=nf, gmean=np.asarray(gmean), resid=resid, states=states,
                run_expr=res.infercnv_obj.expr, run_states=res.hmm_states)


def worker(argv) -> int:
    """One rank of the multiprocess phase: chip_smoke.py --worker RANK WORLD
    PORT DIR DEVICE (gloo, DEVICE as the rank's one shard); writes
    DIR/rank<RANK>.npz."""
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, port, data_dir = int(argv[0]), int(argv[1]), argv[2], Path(argv[3])
    dev = torch.device(argv[4])
    if dev.type == "cuda" and not torch.cuda.is_available():
        return fail("worker: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from infercnv_tpu_torch.parallel.stats import CellMesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        out = _mp_compute(dev, data_dir, CellMesh([dev], group=dist.group.WORLD))
    finally:
        dist.destroy_process_group()
    np.savez(data_dir / f"rank{rank}.npz", **out)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _nccl_one_rank(dev) -> dict:
    """A one-rank NCCL group on the card: the sharded median and to_host
    through NCCL's collectives (CUDA tensors)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from infercnv_tpu_torch.parallel.stats import (
        CellMesh,
        put_cell_sharded,
        sharded_median,
        to_host,
    )

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = CellMesh([dev], group=dist.group.WORLD)
        require(mesh.collective_device() == dev, "nccl: collectives not on the card")
        v = np.random.default_rng(SEED).normal(size=4096).astype(np.float32)
        med = float(sharded_median(v, mesh))
        x = np.arange(4096 * 3, dtype=np.float32).reshape(4096, 3)
        back = to_host(put_cell_sharded(x, mesh))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    require(med == float(np.median(v)), f"nccl: median {med} != {np.median(v)}")
    require(bool(np.array_equal(back, x)), "nccl: to_host did not give the rows back")
    return {"backend": "nccl", "ranks": 1, "median_equal": True, "to_host_equal": True}


def multiprocess_phase(dev, smi, out_root: Path) -> None:
    """Two processes on the one card under gloo (NCCL refuses two ranks on
    one device), each loading its .npy cell slice with load_counts_shard
    and running the sharded median, the group statistics, the engine and
    run() over the 2-rank mesh, against the same work in this process on
    one device; then a one-rank NCCL group through the same collectives."""
    import numpy as np
    import torch

    data_dir = out_root / "multiprocess"
    shutil.rmtree(data_dir, ignore_errors=True)
    data_dir.mkdir(parents=True)
    go = bench_genome()
    rng = np.random.default_rng(SEED)
    lam = np.repeat(rng.gamma(2.0, 30.0, go.num_genes)[None, :], MP_CELLS, axis=0)
    lam[MP_CELLS // 2:, go.chr_gene_indices("chr2")] *= 0.5     # a loss in obs1
    np.save(data_dir / "counts.npy", rng.poisson(lam).astype(np.float32))
    del lam
    torch.cuda.empty_cache()
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--worker",
                               str(r), "2", str(port), str(data_dir), str(dev)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=420)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    mp_s = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        require(p.returncode == 0, f"multiprocess: rank {r} exited {p.returncode}:\n"
                f"{log[-3000:]}")
    one = _mp_compute(dev, data_dir, None)
    ranks = [dict(np.load(data_dir / f"rank{r}.npz")) for r in range(2)]
    for r, z in enumerate(ranks):
        require(float(z["nf"]) == one["nf"], f"multiprocess: rank {r}'s depth factor")
        require(bool(np.array_equal(z["states"], one["states"])),
                f"multiprocess: rank {r}'s engine states differ")
        require(bool(np.array_equal(z["run_states"], one["run_states"])),
                f"multiprocess: rank {r}'s run() states differ")
    resid_err = max(float(np.abs(z["resid"] - one["resid"]).max()) for z in ranks)
    run_err = max(float(np.abs(z["run_expr"] - one["run_expr"]).max()) for z in ranks)
    mean_err = float((np.abs(ranks[0]["gmean"] - one["gmean"])
                      / np.maximum(one["gmean"], 1e-6)).max())
    require(resid_err <= RESID_TOL * 4 and run_err <= 1e-5 and mean_err <= 1e-6,
            f"multiprocess: resid {resid_err}, run expr {run_err}, means {mean_err}")
    nccl = _nccl_one_rank(dev)
    many = ("not run: one card (NCCL takes one rank a card)"
            if torch.cuda.device_count() < 2 else
            "not run: this phase drives one card")
    emit(phase="multiprocess", card=smi, backend="gloo", ranks=2, cards=1,
         cells=MP_CELLS, genes=go.num_genes,
         workers_s=mp_s, resid_max_abs_err=resid_err, run_expr_max_abs_err=run_err,
         group_mean_max_rel_err=mean_err, states_equal=True, nccl_one_rank=nccl,
         nccl_many_cards=many)


def median_filter_timing(obj, dev) -> dict:
    """apply_median_filtering on the card: one 4,096-cell group timed first,
    then the whole object when that group's time predicts at most
    MEDIAN_FILTER_WHOLE_S seconds for it."""
    import numpy as np
    import torch

    from infercnv_tpu_torch.core.object import InferCNV
    from infercnv_tpu_torch.ops.median_filter import apply_median_filtering

    name = next(iter(obj.obs_groups))
    idx = np.asarray(obj.obs_groups[name])
    one = InferCNV(expr=np.asarray(obj.expr[idx]), counts=None, gene_order=obj.gene_order,
                   cell_names=[obj.cell_names[i] for i in idx], ref_groups={},
                   obs_groups={name: np.arange(idx.size)})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    apply_median_filtering(one, device=dev)
    torch.cuda.synchronize()
    group_s = time.perf_counter() - t0
    out = {"group": name, "group_cells": int(idx.size), "group_s": group_s,
           "genes": int(obj.num_genes)}
    predicted = group_s * obj.num_cells / idx.size
    if predicted <= MEDIAN_FILTER_WHOLE_S:
        whole = obj.shallow_copy()
        t0 = time.perf_counter()
        apply_median_filtering(whole, device=dev)
        torch.cuda.synchronize()
        out.update(whole_cells=int(obj.num_cells), whole_s=time.perf_counter() - t0)
    else:
        out.update(whole="not run: one group's time predicts "
                   f"{predicted:.1f} s for the whole object")
    return out


def _write_inputs(obj, d: Path):
    """The object as the reference's three input files (tab-delimited)."""
    import numpy as np

    d.mkdir(parents=True, exist_ok=True)
    go = obj.gene_order
    counts = np.asarray(obj.counts if obj.counts is not None else obj.expr)
    with open(d / "counts.tsv", "w") as f:
        f.write("\t".join(obj.cell_names) + "\n")
        for g, row in zip(go.names, counts.T.astype(np.int64)):
            f.write(g + "\t" + "\t".join(map(str, row.tolist())) + "\n")
    with open(d / "genes.txt", "w") as f:
        for i, g in enumerate(go.names):
            f.write(f"{g}\t{go.chr_names[go.chr_ids[i]]}\t{int(go.start[i]) + 1}"
                    f"\t{int(go.stop[i]) + 1}\n")
    with open(d / "annots.txt", "w") as f:
        groups = {**obj.obs_groups, **obj.ref_groups}
        for name, idx in groups.items():
            for i in idx:
                f.write(f"{obj.cell_names[i]}\t{name}\n")
    return d / "counts.tsv", d / "genes.txt", d / "annots.txt"


def entry_points_phase(obj, dev, smi, out_root: Path, mf_timing: dict) -> None:
    """The CLI on files written from the 1,024-cell object (its run()
    against a direct run() with the arguments the CLI passed: exit 0, the
    file set as run() writes it plus the CLI's own, the region reports
    byte-equal), run(sim_method="splatter") gated on its planted calls, and
    the median filter on the card against the CPU, with its timing."""
    import filecmp

    import numpy as np

    import infercnv_tpu_torch.runner.pipeline as pipeline
    from infercnv_tpu_torch import cli
    from infercnv_tpu_torch.ops.median_filter import apply_median_filtering

    d = out_root / "entry_points"
    shutil.rmtree(d, ignore_errors=True)
    counts, genes, annots = _write_inputs(obj, d / "inputs")
    mpl = have_matplotlib()
    argv = ["--raw_counts_matrix", str(counts), "--gene_order_file", str(genes),
            "--annotations_file", str(annots), "--ref_group_names", "ref0,ref1",
            "--out_dir", str(d / "cli"), "--HMM", "--denoise", "--median_filter",
            "--no_save_rds", "--BayesMaxPNormal", "0", "--device", str(dev)]
    if not mpl:   # the CLI plots the median-filtered object outside run()
        argv.append("--no_plot")
    seen = {}
    real_run = pipeline.run

    def recording_run(o, **kw):
        seen.update(obj=o, kw=kw)
        return real_run(o, **kw)

    pipeline.run = recording_run
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        cli_s = time.perf_counter() - t0
    finally:
        pipeline.run = real_run
    require(rc == 0, f"entry_points: the CLI exited {rc}")
    direct = dict(seen["kw"], out_dir=str(d / "run"))
    res = real_run(seen["obj"], **direct)
    files = lambda p: {f.name for f in p.iterdir()}
    cli_files, run_files = files(d / "cli"), files(d / "run")
    extra = cli_files - run_files
    require(run_files <= cli_files and extra <= {
        "map_metadata_from_infercnv.txt", "top_dupli.txt", "top_losses.txt",
        "infercnv.median_filtered.png", "infercnv.median_filtered.observation_groupings.txt",
        "infercnv.median_filtered.heatmap_thresholds.txt"},
        f"entry_points: the CLI's files differ from run()'s: {sorted(extra)} / "
        f"{sorted(run_files - cli_files)}")
    reports = sorted(f for f in run_files if f.endswith("pred_cnv_regions.dat"))
    require(reports and all(filecmp.cmp(d / "cli" / f, d / "run" / f, shallow=False)
                            for f in reports),
            f"entry_points: the CLI's region reports differ from run()'s: {reports}")
    # run(sim_method="splatter") at i6 on the same object
    rs, ws, n = drive_run(obj, d / "splatter", dev, HMM=True, HMM_type="i6",
                          sim_method="splatter", analysis_mode="subclusters",
                          tumor_subcluster_partition_method="qnorm", BayesMaxPNormal=0)
    calls = run_calls(rs, neutral=3)
    sub = calls["per_subcluster_min"]
    require(sub["del_chr2"] > 0.7 and sub["amp_chr5"] > 0.7
            and calls["neutral_obs0_3_refs"] > 0.9,
            f"entry_points: splatter run: planted CNVs not called: {calls}")
    # the median filter: the card against the CPU on the direct run's object
    a, b = res.infercnv_obj.shallow_copy(), res.infercnv_obj.shallow_copy()
    t0 = time.perf_counter()
    apply_median_filtering(a, device=dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    apply_median_filtering(b, device="cpu")
    cpu_s = time.perf_counter() - t0
    require(bool(np.array_equal(a.expr, b.expr)),
            "entry_points: the median filter differs between the card and the CPU")
    emit(phase="entry_points", card=smi, cli={"exit": rc, "seconds": cli_s,
         "files": len(cli_files), "cli_only_files": sorted(extra),
         "reports_byte_equal": reports, "plots": mpl},
         splatter={"called": calls, "wall_s": ws, "launches": n},
         median_filter={"cells": int(a.num_cells), "equal_card_cpu": True,
                        "card_s": card_s, "cpu_s": cpu_s, "timing": mf_timing})


def warm_up(engine, inp) -> float:
    """Two subcluster_chunk calls before a path is timed, outside its launch
    count, the first one's result held while the second runs, as drive()
    holds it; returns their host-clock ms.  The first chunks after the
    kernels phase also allocate the outputs that a stream keeps in flight
    (three 1.1 GB blocks on the main path), which the caching allocator
    then reuses: the paths' rates are those of the steady stream."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    held = None
    for counts in (inp.counts_a, inp.counts_b):
        held, *_ = engine.subcluster_chunk(counts, inp.nf, inp.ml, inp.mr,
                                           inp.noise, inp.onehot)
    torch.cuda.synchronize()
    del held
    return (time.perf_counter() - t0) * 1e3


def drive(engine, inp, n_iter: int):
    """The streaming path on one engine: n_iter subcluster_chunk calls
    alternating the two chunks, then the group-mean Viterbi.  Returns
    (last residual, (sums, counts), states, spans): spans are a CUDA event
    pair around each chunk (they add no synchronisation)."""
    import torch

    acc, spans = None, []
    for i in range(n_iter):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        resid, *acc = engine.subcluster_chunk(
            inp.counts_a if i % 2 == 0 else inp.counts_b, inp.nf, inp.ml,
            inp.mr, inp.noise, inp.onehot, acc=acc)
        b.record()
        spans.append((a, b))
    states = engine.viterbi_group_means(acc[0] / acc[1][:, None])
    return resid, acc, states, spans


def span_ms(spans) -> float:
    """Mean device span of a path's chunks (after a synchronize)."""
    return sum(a.elapsed_time(b) for a, b in spans) / len(spans)


def median_awkward(dev, yc, yw) -> dict:
    """Awkward shapes of the median kernels, name -> (rows, width): rows
    not 16-byte aligned (8447 genes), widths of 1 and 2, one row and fewer
    rows than the persistent grid, rows of one value (every lane's digits
    in one bin), the widths either side of the plan's switch from blocks of
    256 threads to one block of 1024 an SM, and either side of its split
    point S (the values the row buffer holds; wider rows read the rest from
    device memory), and 60,000 genes as the first columns of rows of stride
    60,005."""
    import torch

    from infercnv_tpu_torch.ops.median import card_plan

    G = yc.shape[1]
    S = card_plan(WIDE_GENES, WIDE_GENES, dev).capacity
    threads = [card_plan(g, g, dev).threads for g in range(1, S + 1)]
    switches = [g for g in range(2, S + 1) if threads[g - 1] != threads[g - 2]]
    pad = torch.full((yw[:100].shape[0], WIDE_GENES + 5), float("inf"),
                     device=dev)
    pad[:, :WIDE_GENES] = yw[:100]
    cases = {"G8447_C4133": yc[:4133, :G - 1].contiguous(),
             "G8448_C1": yc[:1], "G8448_C100": yc[:100],
             "G8448_C4133": yc[:4133],
             "G1_C100": yc[:100, :1].contiguous(),
             "G2_C100": yc[:100, :2].contiguous(),
             "G8448_equal_C100": torch.full((100, G), 0.375, device=dev),
             f"G{WIDE_GENES}_equal_C100": torch.full((100, WIDE_GENES), -1.5,
                                                    device=dev),
             f"G{WIDE_GENES}_ld{WIDE_GENES + 5}_C100": pad[:, :WIDE_GENES]}
    for g in sorted({w for s in switches for w in (s - 1, s)}
                    | {S - 1, S, S + 1, S + 4}):
        cases[f"G{g}_C100"] = yw[:100, :g].contiguous()
    return {k: (v, v.shape[1]) for k, v in cases.items()}


def sync_count(fn) -> dict:
    """One call of fn, after one warm call, under torch.profiler (the switch
    of the program's spans and counters) with CUDA's sync-debug mode on:
    the synchronising operations that mode reports, the increase of the
    program's ``host_syncs`` counter, and the package's lines that made
    the reports."""
    import traceback
    import warnings
    from collections import Counter

    import torch

    from infercnv_tpu_torch.utils import profiling

    pkg = str(ROOT / "infercnv_tpu_torch")
    sites, inside = [], []

    def report(message, category, filename, lineno, file=None, line=None):
        # fn's reports only: switching the mode on reports a sync itself
        if inside and "synchronizing" in str(message):
            ours = [f for f in traceback.extract_stack() if f.filename.startswith(pkg)]
            sites.append(f"{Path(ours[-1].filename).name}:{ours[-1].lineno}" if ours
                         else f"{Path(filename).name}:{lineno}")

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        before = profiling.counter_totals().get(profiling.HOST_SYNCS, 0)
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = report
            torch.cuda.set_sync_debug_mode("warn")
            try:
                inside.append(True)
                fn()
            finally:
                inside.clear()
                torch.cuda.set_sync_debug_mode("default")
        counted = profiling.counter_totals().get(profiling.HOST_SYNCS, 0) - before
    torch.cuda.synchronize()
    profiling.reset_spans()
    return {"sync_debug": len(sites), "host_syncs": counted,
            "sites": dict(Counter(sites))}


def ref_stats_ops(engine, counts, nf: float, onehot):
    """The one-shot ref_stats as separate PyTorch ops (the smooth and the
    median on kernels 3 or 5 and 7), as the engine ran it before its three
    row kernels: the yardstick of the engine's ref_stats."""
    import torch

    from infercnv_tpu_torch.ops.ref_stats import log_norm_plain

    mct = engine.config.max_centered_threshold
    xlog = log_norm_plain(counts, nf)
    gn = onehot.sum(dim=1, keepdim=True)
    ml = (onehot @ xlog) / gn
    x = torch.clamp(engine._subtract(xlog, ml), -mct, mct)
    del xlog
    x = engine._centre(engine._smooth(x))
    mr = (onehot @ x) / gn
    final = torch.exp2(engine._subtract(x, mr))
    sd = final.std(dim=1, correction=1).mean() * engine.config.sd_amplifier
    return ml, mr, torch.stack([final.mean(), sd])


def ref_stats_phase(dev, smi, inp, routes: dict) -> dict:
    """ref_stats' three row kernels against their plain versions on the card,
    at the benchmark's shape ([13,108, 8448] u16, 2 groups) and on an
    8447-gene genome (rows not 16-byte aligned), with kernel 1's tolerance,
    each one's ms beside its bound; then the engine's ref_stats against the
    op-by-op form (rtol 1e-5, atol 1e-6; bf16: kernel 1's tolerance) on each
    engine of routes (name -> (engine, ref counts, nf, onehot)) and at the
    benchmark's shape, with its launches a call: log_norm and noise_rows
    always, ref_centred where the engine plans the fused front.  Returns the
    kernels' rows of the kernel table."""
    import numpy as np
    import torch

    from infercnv_tpu_torch.ops.layout import smoothing_operator
    from infercnv_tpu_torch.ops.ref_stats import (
        log_norm, log_norm_plain, noise_rows, noise_rows_plain)
    from infercnv_tpu_torch.ops.residual_fused import ref_centred, ref_centred_plain
    from infercnv_tpu_torch.ops.smoothing import BandWeights

    def close(got, want, rtol=RESID_TOL, atol=RESID_TOL):
        err = (got.float() - want.float()).abs()
        return bool((err <= atol + rtol * want.float().abs()).all()), float(err.max())

    e = inp.engine
    G = e.gene_order.num_genes
    mct = e.config.max_centered_threshold
    rng = np.random.default_rng(SEED + 17)
    gene_means = torch.tensor(rng.gamma(2.0, 30.0, G), dtype=torch.float32,
                              device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    R = BENCH_REF_CELLS
    counts = make_counts(gene_means[None, :].repeat(R, 1), gen)
    onehot = torch.zeros((2, R), device=dev)
    onehot[torch.arange(R, device=dev) % 2, torch.arange(R, device=dev)] = 1
    w7 = BandWeights.from_operator(smoothing_operator(bench_genome(G - 1), 101), dev)
    cases = {"G8448_R13108": (counts, onehot, e._w_smooth),
             "G8447_R1024": (counts[:ODD_REF_CELLS, :G - 1].contiguous(),
                             onehot[:, :ODD_REF_CELLS], w7)}
    errs = {"log_norm": {}, "ref_centred": {}, "noise_rows": {}}
    for name, (c, oh, w) in cases.items():
        gn = oh.sum(dim=1, keepdim=True)
        xl = log_norm_plain(c, inp.nf)
        ok, errs["log_norm"][name] = close(log_norm(c, inp.nf), xl)
        require(ok, f"log_norm ({name}) differs from its plain version")
        b1 = e._bounds((oh @ xl) / gn)
        del xl
        x = ref_centred_plain(c, w, *b1, inp.nf, mct)
        ok, errs["ref_centred"][name] = close(ref_centred(c, w, *b1, inp.nf, mct), x)
        require(ok, f"ref_centred ({name}) differs from its plain version")
        b2 = e._bounds((oh @ x) / gn)
        ok, errs["noise_rows"][name] = close(noise_rows(x, *b2),
                                             noise_rows_plain(x, *b2))
        require(ok, f"noise_rows ({name}) differs from its plain version")
        del x
    # times at the benchmark's shape
    w = e._w_smooth
    gn = onehot.sum(dim=1, keepdim=True)
    xl = log_norm(counts, inp.nf)
    b1 = e._bounds((onehot @ xl) / gn)
    del xl
    x = ref_centred(counts, w, *b1, inp.nf, mct)
    b2 = e._bounds((onehot @ x) / gn)
    nnz = 2.0 * int((w.band != 0).sum())
    cells, in_b = R * G, counts.element_size()
    rows = {
        "log_norm": dict(
            ms=time_ms(lambda: log_norm(counts, inp.nf)),
            plain_ms=time_ms(lambda: log_norm_plain(counts, inp.nf), reps=3),
            bound=bound(cells * (in_b + 4), 0.0)),
        "ref_centred": dict(
            ms=time_ms(lambda: ref_centred(counts, w, *b1, inp.nf, mct)),
            plain_ms=time_ms(lambda: ref_centred_plain(counts, w, *b1, inp.nf, mct),
                             reps=3),
            bound=bound(cells * (in_b + 4), nnz * R)),
        "noise_rows": dict(
            ms=time_ms(lambda: noise_rows(x, *b2)),
            plain_ms=time_ms(lambda: noise_rows_plain(x, *b2), reps=3),
            bound=bound(cells * 4 + R * 8, 0.0)),
    }
    for k, r in rows.items():
        r.update(max_abs_err=errs[k]["G8448_R13108"], awkward_max_abs_err=errs[k],
                 library_ms=None, shape=[R, G], bound_ms=r["bound"][0],
                 bound_by=r["bound"][1])
    del x
    # the engine's ref_stats against the op-by-op form, route by route
    routes = {**routes, "bench_shape": (e, counts, inp.nf, onehot)}
    engines = {}
    for name, (eng, c, nf, oh) in routes.items():
        reset_launches()
        got = eng.ref_stats(c, nf, oh)
        torch.cuda.synchronize()
        n = read_launches()
        want = ref_stats_ops(eng, c, nf, oh)
        bf16 = eng._w_smooth.bf16
        tol = (RESID_TOL, RESID_TOL) if bf16 else (1e-5, 1e-6)
        err = []
        for g, o, what in zip(got, want, ("ref_means_log", "ref_means_resid",
                                          "noise_bounds")):
            ok, er = close(g, o, *tol)
            require(ok, f"ref_stats ({name}): {what} differs from the op-by-op "
                    f"form (max {er})")
            err.append(er)
        fused = eng.ref_residual_route == "fused"
        mine = {k: n[k] for k in ("log_norm", "ref_centred", "noise_rows")}
        others = sum(v for k, v in n.items() if k not in mine)
        require(mine == {"log_norm": 1, "ref_centred": int(fused), "noise_rows": 1}
                and (others == 0 or not fused),
                f"ref_stats ({name}): launches {n} on the {eng.ref_residual_route} route")
        engines[name] = dict(
            route=eng.ref_residual_route, rows=int(c.shape[0]), genes=int(c.shape[1]),
            launches_a_call=sum(mine.values()), launches=n, max_abs_err=err,
            ms=time_ms(lambda: eng.ref_stats(c, nf, oh), reps=3),
            ops_ms=time_ms(lambda: ref_stats_ops(eng, c, nf, oh), reps=3))
        del got, want
    emit(phase="ref_stats", card=smi, kernels=rows, engines=engines)
    del counts
    torch.cuda.empty_cache()
    return rows


def ref_stats_only(dev) -> int:
    """chip_smoke.py --ref-stats: the build and the ref_stats phase alone, on
    the path engines of a full run."""
    import dataclasses

    import torch

    from infercnv_tpu_torch.ops import _build
    from infercnv_tpu_torch.parallel.engine import CnvEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    ptxas = [ln.strip() for ln in
             (lib_path.parent / "build.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit(phase="build", seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas)
    inp = make_inputs(dev)
    cin = make_inputs(dev, go=human_like_genome(inp.go.num_genes),
                      smooth_method="coordinates", window_length=COORD_WINDOW)
    win = make_inputs(dev, go=human_like_genome(WIDE_GENES), chunk=WIDE_CHUNK)
    be = CnvEngine(inp.go, inp.hmm,
                   dataclasses.replace(inp.config, matmul_dtype="bfloat16"), device=dev)
    ref_stats_phase(dev, smi, inp, ref_stats_routes(inp, cin, win, be))
    print(json.dumps({"ok": True}), flush=True)
    return 0


def ref_stats_routes(inp, cin, win, be) -> dict:
    """ref_stats_phase's engines: each path's, on its reference cells."""
    return {name: (i.engine if eng is None else eng, i.ref_counts, i.nf, i.onehot_ref)
            for name, i, eng in (("main", inp, None), ("coordinates", cin, None),
                                 ("wide_genome", win, None), ("bf16", inp, be))}


def host_syncs_phase(smi, inp, e3, cin, c_stats) -> None:
    """The program's host_syncs counter against CUDA's sync-debug count, one
    call of each engine route the benchmark drives: ref_stats, the fused
    subcluster_chunk and full_chunk (i6), the wide-band full_chunk (i3,
    coordinates) and viterbi_group_means; the two must be equal."""
    eng = inp.engine
    _, sums, counts = eng.subcluster_chunk(inp.counts_a, inp.nf, inp.ml, inp.mr,
                                           inp.noise, inp.onehot)
    means = sums / counts[:, None]
    cells = 8192
    calls = {
        "ref_stats": lambda: eng.ref_stats(inp.ref_counts, inp.nf, inp.onehot_ref),
        "subcluster_chunk.fused": lambda: eng.subcluster_chunk(
            inp.counts_a, inp.nf, inp.ml, inp.mr, inp.noise, inp.onehot),
        "full_chunk.fused_i6": lambda: eng.full_chunk(
            inp.counts_a[:cells], inp.nf, inp.ml, inp.mr, inp.noise),
        "full_chunk.wide_band_i3": lambda: e3.full_chunk(
            cin.counts_a[:cells], cin.nf, *c_stats),
        "viterbi_group_means": lambda: eng.viterbi_group_means(means),
    }
    out = {name: sync_count(fn) for name, fn in calls.items()}
    emit(phase="host_syncs", card=smi, routes=out)
    for name, r in out.items():
        require(r["sync_debug"] == r["host_syncs"],
                f"host_syncs: {name} counted {r['host_syncs']}, the sync-debug "
                f"mode reported {r['sync_debug']} ({r['sites']})")


def run(dev) -> int:
    import numpy as np
    import torch

    import dataclasses
    import types

    from infercnv_tpu_torch.models.hmm import i3_hmm_params
    from infercnv_tpu_torch.ops import _build
    from infercnv_tpu_torch.ops.median import (
        card_plan, median_center_residual, median_center_residual_plain,
        row_median, row_median_plain)
    from infercnv_tpu_torch.ops.residual_fused import (
        counts_to_f32, denoise, residual_fused, residual_fused_plain)
    from infercnv_tpu_torch.ops.layout import (
        coordinate_smoothing_operator, smoothing_operator)
    from infercnv_tpu_torch.ops.smoothing import (
        BandWeights, apply_banded, apply_banded_general, apply_banded_plain)
    from infercnv_tpu_torch.ops.viterbi_kernel import card_plan as viterbi_card_plan
    from infercnv_tpu_torch.ops.viterbi_kernel import launch as viterbi_launch
    from infercnv_tpu_torch.ops.viterbi_kernel import latency_smem_bytes as viterbi_smem_bytes
    from infercnv_tpu_torch.ops.viterbi_kernel import (
        transition_logs, viterbi, viterbi_plain)
    from infercnv_tpu_torch.ops.viterbi_pack import viterbi_packed
    from infercnv_tpu_torch.parallel.engine import CnvEngine

    # ---- device -------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit(phase="device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # ---- build --------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    ptxas = [ln.strip() for ln in
             (lib_path.parent / "build.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=round(time.perf_counter() - t0, 3),
         library=lib_path.name, ptxas=ptxas)

    # ---- shared inputs ------------------------------------------------
    inp = make_inputs(dev)
    go, hmm, engine = inp.go, inp.hmm, inp.engine
    counts_a, counts_b, ref_counts, nf = (inp.counts_a, inp.counts_b,
                                          inp.ref_counts, inp.nf)
    onehot_ref, onehot, gen = inp.onehot_ref, inp.onehot, inp.gen
    ml, mr, noise = inp.ml, inp.mr, inp.noise
    b1, b2 = inp.bounds[:2], inp.bounds[2:]
    G = go.num_genes
    w = engine.weights
    nnz = int((w.band != 0).sum())
    # coordinate smoothing on a genome shaped like GRCh38
    hgo = human_like_genome(G)
    cin = make_inputs(dev, go=hgo, smooth_method="coordinates",
                      window_length=COORD_WINDOW)
    cw = cin.engine.weights
    require(cw.side_tiles > 1 and cin.engine.residual_route == "wide_band",
            f"coordinates: halfband {cw.halfband} does not take the wide-band route")
    # 60,000 genes: too wide for the fused kernel
    wgo = human_like_genome(WIDE_GENES)
    win = make_inputs(dev, go=wgo, chunk=WIDE_CHUNK)
    require(win.engine.residual_route == "wide_genome",
            f"{WIDE_GENES} genes take the {win.engine.residual_route} route")
    # the bench workload with the bf16 smooth
    be = CnvEngine(go, hmm, dataclasses.replace(inp.config, matmul_dtype="bfloat16"),
                   device=dev)
    require(be.residual_route == "fused" and be.smooth_route == "row"
            and be._w_fused.bf16 and be._w_smooth.bf16, "bf16 engine routes")
    emit(phase="routes",
         main={"residual": engine.residual_route, "smooth": engine.smooth_route},
         coordinates={"residual": cin.engine.residual_route,
                      "smooth": cin.engine.smooth_route, "halfband": cw.halfband,
                      "side_tiles": cw.side_tiles,
                      "band_nonzeros": int((cw.band != 0).sum()),
                      "mean_tile_taps": float((cw.tap_hi - cw.tap_lo).float().mean()),
                      "max_tap_span": cw.max_span},
         wide_genome={"residual": win.engine.residual_route,
                      "smooth": win.engine.smooth_route, "genes": WIDE_GENES},
         bf16={"residual": be.residual_route, "smooth": be.smooth_route})

    def close(got, want, tol=RESID_TOL):
        err = (got.float() - want.float()).abs()
        ok = bool((err <= tol + tol * want.float().abs()).all())
        return ok, float(err.max())

    def bits_equal(a, b):
        return torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))

    rows = {}

    # ---- kernels 3 and 4: banded smooth [256, 8448], f32 and bf16 -------
    # (and ref_stats' chunk of 16,384 rows; awkward shapes: G = 8447, whose
    # rows are not 16-byte aligned, and one row, fewer blocks than SMs).
    # ms: the device time (graph_ms); ms_one_call: one call timed alone, as
    # earlier runs timed it (host time included)
    wb = be._w_smooth
    ws7 = {bf: BandWeights.from_operator(smoothing_operator(bench_genome(G - 1), 101),
                                         dev, bf16=bf) for bf in (False, True)}
    x = torch.randn((N_REF, G), generator=gen, device=dev)
    xl = torch.randn((REF_CHUNK, G), generator=gen, device=dev)
    s_cases = {"G8448_C256": (x, w, wb), "G8447_C256": (x[:, :G - 1].contiguous(), *ws7.values()),
               "G8448_C1": (x[:1], w, wb), "G8448_C16384": (xl, w, wb)}
    s_err = {False: {}, True: {}}
    for name, (xx, wf, wh) in s_cases.items():
        yk = apply_banded(xx, wf)
        ok, e = close(yk, apply_banded_plain(xx, wf))
        require(ok, f"smooth_banded ({name}) differs from its plain version (max {e})")
        s_err[False][name] = e
        yk4 = apply_banded(xx, wh)
        ok, e = close(yk4, apply_banded_plain(xx, wh), tol=1e-5)
        require(ok, f"smooth_banded_bf16 ({name}) differs from its plain version (max {e})")
        s_err[True][name] = e
        # bf16 keeps 8 significant bits: each product moves by at most
        # (2u + u^2) of |w||x|, u = 2^-8 (plus the f32 sums)
        diff = (yk4 - yk).abs()
        rb = (2.0 ** -7 + 2.0 ** -16) * apply_banded(xx.abs(), wf) + 1e-6
        require(bool((diff <= rb).all()), f"smooth_banded_bf16 ({name}): beyond the "
                f"bf16 rounding bound of the f32 smooth (max {float(diff.max())})")
        if name == "G8448_C256":
            bf16_diff = (float(diff.max()), float(diff.max() / yk.abs().max()))
        del yk, yk4, diff, rb
    del ws7
    W = w.dense()
    for name, wt, lib_ms in (("smooth_banded", w, time_ms(lambda: torch.matmul(x, W))),
                             ("smooth_banded_bf16", wb, None)):
        nz = 2.0 * int((wt.band != 0).sum())
        rows[name] = dict(
            max_abs_err=s_err[wt.bf16]["G8448_C256"],
            awkward_max_abs_err=s_err[wt.bf16],
            ms=graph_ms(lambda: apply_banded(x, wt)),
            ms_one_call=time_ms(lambda: apply_banded(x, wt)),
            ms_16384=time_ms(lambda: apply_banded(xl, wt)),
            plain_ms=time_ms(lambda: apply_banded_plain(x, wt)),
            plain_ms_16384=time_ms(lambda: apply_banded_plain(xl, wt), reps=3),
            library_ms=lib_ms,
            bound=bound(2 * x.numel() * 4 + wt.band.numel() * 4, nz * N_REF),
            bound_ms_16384=bound(2 * xl.numel() * 4 + wt.band.numel() * 4,
                                 nz * REF_CHUNK)[0],
            spans_a_row=wt.spans.nspan, shape=list(x.shape),
            shape_16384=list(xl.shape))
    rows["smooth_banded_bf16"].update(max_abs_diff_from_f32=bf16_diff[0],
                                      max_diff_from_f32_over_max_f32=bf16_diff[1])
    del W, x, xl

    # ---- kernel 1: fused residual [32768, 8448] u16 -> f32/f16/bf16 ----
    rk = {odt: residual_fused(counts_a, w, *b1, *b2, nf, out_dtype=odt)
          for odt in (torch.float32, torch.float16, torch.bfloat16)}
    rp = residual_fused_plain(counts_a, w, *b1, *b2, nf)
    torch.cuda.synchronize()
    ok, err = close(rk[torch.float32], rp)
    require(ok, f"residual_fused differs from its plain version (max {err})")
    for odt in (torch.float16, torch.bfloat16):
        require(torch.equal(rk[odt], rk[torch.float32].to(odt)),
                f"residual_fused {odt} output is not the cast of its f32 output")
    del rp
    r_dn, dn = residual_fused(counts_a, w, *b1, *b2, nf, noise_bounds=noise)
    require(torch.equal(r_dn, rk[torch.float32])
            and torch.equal(dn, denoise(r_dn, noise)),
            "residual_fused: the denoised output differs from denoise()")
    del r_dn, dn
    small = counts_a[:4096]
    variants = {}
    mean_bounds = [ml.mean(0)] * 2 + [mr.mean(0)] * 2
    for name, bb, centre_mean in (("center_mean", [*b1, *b2], True),
                                  ("no_bounds", mean_bounds, False)):
        got = residual_fused(small, w, *bb, nf, center_mean=centre_mean)
        want = residual_fused_plain(small, w, *bb, nf, center_mean=centre_mean)
        ok, e = close(got, want)
        require(ok, f"residual_fused ({name}) differs from its plain version (max {e})")
        variants[name] = e
    require(torch.equal(residual_fused(counts_to_f32(small).contiguous(), w, *b1, *b2, nf),
                        rk[torch.float32][:4096]),
            "residual_fused: f32 counts and u16 counts disagree")
    # awkward shapes: G = 8447 (odd; u16 rows start at odd 2-byte offsets,
    # so the 16-byte reads need a scalar head and tail), 4133 rows (not a
    # multiple of the persistent grid), one row, and rows of mostly zero
    # counts (ties in the select)
    w7 = BandWeights.from_operator(smoothing_operator(bench_genome(G - 1), 101), dev)
    b7 = [v[:G - 1].contiguous() for v in (*b1, *b2)]
    c7 = counts_a[:4133, :G - 1].contiguous()
    cz = counts_a[:4133].clone()
    c7[:64, 100:] = 0
    cz[:64, 100:] = 0
    awkward = {}
    for name, cc, ww_, bb in (("G8447_C4133", c7, w7, b7),
                              ("G8447_C1", c7[:1], w7, b7),
                              ("G8448_C1", counts_a[:1], w, [*b1, *b2]),
                              ("G8448_C4133_zero_rows", cz, w, [*b1, *b2])):
        got, dn = residual_fused(cc, ww_, *bb, nf, noise_bounds=noise)
        ok, e = close(got, residual_fused_plain(cc, ww_, *bb, nf))
        require(ok and torch.equal(dn, denoise(got, noise)),
                f"residual_fused ({name}) differs from its plain version (max {e})")
        awkward[name] = e
    del w7, c7, cz, got, dn
    # The main path runs the variant with the denoised second output (its
    # residual equals the f32 one above bit for bit, and the denoised output
    # equals denoise() of it), so the row's time and bound are that
    # variant's: the counts in, two f32 outputs, the band and bound rows.
    c_bytes = counts_a.numel() * 2 + w.band.numel() * 4 + 4 * G * 4
    rows["residual_fused"] = dict(
        max_abs_err=err, variants_max_abs_err=variants,
        awkward_max_abs_err=awkward,
        ms=time_ms(lambda: residual_fused(counts_a, w, *b1, *b2, nf,
                                          noise_bounds=noise)),
        ms_without_denoised=time_ms(lambda: residual_fused(counts_a, w, *b1, *b2, nf)),
        ms_f16_out=time_ms(lambda: residual_fused(counts_a, w, *b1, *b2, nf,
                                                  out_dtype=torch.float16)),
        plain_ms=time_ms(lambda: residual_fused_plain(
            counts_a, w, *b1, *b2, nf, noise_bounds=noise), reps=3),
        library_ms=None,
        bound=bound(c_bytes + 2 * counts_a.numel() * 4, 2.0 * nnz * CHUNK),
        bound_ms_without_denoised=bound(c_bytes + counts_a.numel() * 4,
                                        2.0 * nnz * CHUNK)[0],
        shape=list(counts_a.shape))
    # the bf16 variant, as the bf16 path runs it (with the denoised output)
    wfb = be._w_fused
    got = residual_fused(counts_a, wfb, *b1, *b2, nf)
    ok, err = close(got, residual_fused_plain(counts_a, wfb, *b1, *b2, nf))
    require(ok, f"residual_fused (bf16) differs from its plain version (max {err})")
    _, e32 = close(got, rk[torch.float32], tol=0.0)
    del got
    rows["residual_fused_bf16"] = dict(
        max_abs_err=err, max_abs_diff_from_f32=e32,
        ms=time_ms(lambda: residual_fused(counts_a, wfb, *b1, *b2, nf,
                                          noise_bounds=noise)),
        plain_ms=time_ms(lambda: residual_fused_plain(
            counts_a, wfb, *b1, *b2, nf, noise_bounds=noise), reps=3),
        library_ms=None,
        bound=bound(c_bytes + 2 * counts_a.numel() * 4,
                    2.0 * int((wfb.band != 0).sum()) * CHUNK),
        shape=list(counts_a.shape))

    # ---- kernel 2: Viterbi, subcluster (B = 208) and cells mode, i6 and i3,
    # each shape in both regimes of the launch plan
    def packer(layout):
        gather = torch.as_tensor(layout.gather, dtype=torch.int64, device=dev)
        n_bins, L = gather.shape
        lens_bin = torch.as_tensor(layout.valid.sum(axis=1), dtype=torch.int32,
                                   device=dev)
        bnd_bin = torch.as_tensor(layout.boundaries, device=dev)

        def packed(resid, sig):
            C = resid.shape[0]
            return (resid[:, gather].reshape(C * n_bins, L), lens_bin.repeat(C),
                    torch.full((C * n_bins,), sig, device=dev),
                    bnd_bin.repeat(C, 1))
        return packed

    def hmm_args(means, t=1e-6):
        log_diag, log_off, log_delta = transition_logs(len(means), t)
        return (np.asarray(means, np.float32), log_delta, log_diag, log_off)

    def check_states(args, hargs, what):
        """The kernel's states equal the plain version's, in both regimes,
        and in the latency regime also with its backpointers in device
        memory (the plan's choice for sequences too long for shared
        memory)."""
        want = viterbi_plain(*args, *hargs)
        B_, L_ = args[0].shape
        S_ = len(hargs[0])
        lat = viterbi_card_plan(B_, L_, S_, dev, regime="latency")
        plans = {"latency": lat, "throughput": viterbi_card_plan(
                     B_, L_, S_, dev, regime="throughput"),
                 "latency, backpointers in device memory": dataclasses.replace(
                     lat, bp_shared=False, smem_bytes=viterbi_smem_bytes(
                         S_, L_, lat.ring, lat.threads, False))}
        for regime, plan in plans.items():
            require(torch.equal(viterbi(*args, *hargs, plan=plan), want),
                    f"viterbi ({what}, {regime} regime) states differ from the "
                    "plain version")

    def check_viterbi(hmm_, packed, resid, what):
        hargs_ = hmm_args(hmm_.means, hmm_.t)
        sigma = float(np.float32(np.median(hmm_.sds)))
        gm = (onehot @ resid) / onehot.sum(dim=1, keepdim=True)
        args_sub_ = packed(gm, sigma)
        for mode, args in (("subclusters", args_sub_),
                           ("cells_4096", packed(resid[:4096], sigma))):
            check_states(args, hargs_, f"{what}, {mode}")
        return args_sub_, hargs_

    r32 = rk[torch.float32]
    packed6 = packer(engine._layout)
    args_sub, hargs = check_viterbi(hmm, packed6, r32, "i6")
    S = hmm.num_states
    B, L = args_sub[0].shape

    def v_bound(args, n_states):
        """Bytes (x in, a state byte out, lengths, sigma) or operations
        (VITERBI_FLOPS a valid (position, state)) of a Viterbi call."""
        Bv, Lv = args[0].shape
        return bound(Bv * Lv * (4 + 1 + 1) + Bv * 8,
                     float(VITERBI_FLOPS) * int(args[1].sum()) * n_states)

    # cells mode: the kernel alone on inputs laid out for it, the wrapper
    # (with its transposes), and the engine's packed call (with the gather
    # and the inverse gather)
    sig6 = float(args_sub[2][0])
    args_full = packed6(r32, sig6)
    plan_full = viterbi_card_plan(*args_full[0].shape, S, dev)
    laid_full = tuple(a.contiguous() for a in args_full)
    sig_rows = torch.full((CHUNK,), sig6, device=dev)
    cells = dict(
        ms_cells_mode_kernel=time_ms(lambda: viterbi_launch(*laid_full, *hargs,
                                                            plan_full), reps=3),
        ms_cells_mode_full_chunk=time_ms(lambda: viterbi(*args_full, *hargs), reps=3),
        ms_cells_mode_packed=time_ms(lambda: viterbi_packed(
            r32, engine._layout, hmm.means, sig_rows, hmm.t), reps=3),
        bound_ms_cells_mode=v_bound(args_full, S)[0],
        plan_cells_mode=dataclasses.asdict(plan_full),
        shape_cells_mode=list(args_full[0].shape))
    del args_full, laid_full, rk, r32
    # i3 (S = 3): the coordinates engine's residual and the i3 parameters
    # from its transformed reference cells
    ref_groups = [np.arange(N_REF // 2), np.arange(N_REF // 2, N_REF)]
    h3 = i3_hmm_params(cin.engine.transform_chunk(cin.ref_counts, cin.nf, cin.ml,
                                                  cin.mr), ref_groups, [])
    rc = cin.engine.transform_chunk(cin.counts_a, cin.nf, cin.ml, cin.mr)
    args_sub3, hargs3 = check_viterbi(h3, packer(cin.engine._layout), rc, "i3")
    del rc
    # the 60,000-gene genome's layout (10 bins of 6460), 16 group means
    wl = win.engine._layout
    gm_w = 1.0 + 0.2 * torch.randn((N_SUB, WIDE_GENES), generator=gen, device=dev)
    gm_w[N_SUB // 2:, :WIDE_GENES // 8] += 0.6
    args_wide = packer(wl)(gm_w, sig6)
    # awkward shapes, each in both regimes for i6 and i3: one sequence, 129
    # of mixed lengths with restarts inside them, L = 1, emissions that tie
    # (x on the round means of hmm_args' models and their midpoints, sigma
    # 0.5), a restart at every position, and the 60,000-gene layout
    L1 = torch.zeros((64, 1), device=dev)
    xm = 1.0 + 0.3 * torch.randn((129, L), generator=gen, device=dev)
    lens_m = torch.randint(1, L + 1, (129,), generator=gen, device=dev,
                           dtype=torch.int32)
    bnd_m = torch.zeros((129, L), dtype=torch.int8, device=dev)
    bnd_m[:, [0, L // 3, 2 * L // 3]] = 1
    bnd_m[torch.arange(L, device=dev)[None, :] >= lens_m[:, None]] = 0

    def ties_args(means):
        grid = torch.tensor(np.concatenate([means, (means[1:] + means[:-1]) / 2]),
                            dtype=torch.float32, device=dev)
        xt = grid[torch.randint(0, grid.shape[0], (160, L), generator=gen, device=dev)]
        bt = torch.zeros((160, L), dtype=torch.int8, device=dev)
        bt[:, [0, L // 2]] = 1
        return (xt, torch.full((160,), L, dtype=torch.int32, device=dev),
                torch.full((160,), 0.5, device=dev), bt)

    round6 = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0])
    round3 = np.array([0.5, 1.0, 1.5])
    v_awkward = []
    for model, ha, sig, rmeans in (("i6", hargs, sig6, round6),
                                   ("i3", hargs3, float(args_sub3[2][0]), round3)):
        cases_v = {
            "B1": tuple(a[:1] for a in args_sub),
            "B129_mixed_lengths": (xm, lens_m, torch.full((129,), sig, device=dev), bnd_m),
            "L1": (L1, torch.ones(64, dtype=torch.int32, device=dev),
                   torch.full((64,), sig, device=dev), torch.zeros((64, 1), dtype=torch.int8,
                                                                  device=dev)),
            "restart_every_position": (*args_sub[:3], torch.ones_like(args_sub[3])),
            f"B160_L{args_wide[0].shape[1]}": args_wide[:2] + (
                torch.full_like(args_wide[2], sig), args_wide[3])}
        for name, args in cases_v.items():
            check_states(args, ha, f"{model}, {name}")
            v_awkward.append(f"{model}_{name}")
        check_states(ties_args(rmeans), hmm_args(rmeans), f"{model}, ties")
        v_awkward.append(f"{model}_ties")
    rows["viterbi"] = dict(
        max_abs_err=0.0, states_equal=True, states_equal_i3=True,
        awkward_states_equal=v_awkward,
        plan=dataclasses.asdict(viterbi_card_plan(B, L, S, dev)),
        ms=graph_ms(lambda: viterbi(*args_sub, *hargs)),
        ms_one_call=time_ms(lambda: viterbi(*args_sub, *hargs)),
        ms_throughput_regime=graph_ms(lambda: viterbi(
            *args_sub, *hargs, plan=viterbi_card_plan(B, L, S, dev, "throughput"))),
        ms_i3_subclusters=graph_ms(lambda: viterbi(*args_sub3, *hargs3)),
        shape_i3_subclusters=list(args_sub3[0].shape),
        bound_ms_i3_subclusters=v_bound(args_sub3, 3)[0],
        ms_wide_genome=graph_ms(lambda: viterbi(*args_wide, *hargs), n=5),
        plan_wide_genome=dataclasses.asdict(viterbi_card_plan(*args_wide[0].shape, S, dev)),
        shape_wide_genome=list(args_wide[0].shape),
        bound_ms_wide_genome=v_bound(args_wide, S)[0],
        **cells,
        plain_ms=time_ms(lambda: viterbi_plain(*args_sub, *hargs), reps=3),
        library_ms=None,
        bound=v_bound(args_sub, S),
        shape=[B, L])
    del args_wide, gm_w, xm

    # ---- kernel 5: general-band smooth, coordinates [32768, 8448] and a
    # 60,000-gene genome [8192, 60000]
    xc = torch.randn((CHUNK, G), generator=gen, device=dev)
    yc = apply_banded_general(xc, cw)
    ok, err = close(yc, apply_banded_plain(xc, cw))
    require(ok, f"smooth_general differs from its plain version (max {err})")
    ww = win.engine.weights
    xw = torch.randn((WIDE_CHUNK, WIDE_GENES), generator=gen, device=dev)
    yw = apply_banded_general(xw, ww)
    ok, err_w = close(yw, apply_banded_plain(xw, ww))
    require(ok, f"smooth_general ({WIDE_GENES} genes) differs from its plain "
            f"version (max {err_w})")
    # with bf16 weights (the wide-genome route under matmul_dtype="bfloat16")
    # the wrapper rounds x before the kernel
    wwb = BandWeights.from_operator(
        coordinate_smoothing_operator(hgo, COORD_WINDOW), dev, bf16=True)
    ok, err_b = close(apply_banded_general(xc[:4096], wwb),
                      apply_banded_plain(xc[:4096], wwb))
    require(ok, f"smooth_general (bf16 weights) differs (max {err_b})")
    del wwb
    # awkward shapes: 1000 rows (not a multiple of the 64-row block) of the
    # 60,000-gene genome, G = 8447 on the coordinates band (rows not 16-byte
    # aligned: 4-byte copies), and output rows of stride ldy > G through the
    # C entry point (the padding must stay untouched)
    cw7 = BandWeights.from_operator(
        coordinate_smoothing_operator(human_like_genome(G - 1), COORD_WINDOW), dev)
    x7 = torch.randn((1013, G - 1), generator=gen, device=dev)
    g_awkward = {}
    for name, xx, ww_ in (("G60000_C1000", xw[:1000], ww), ("G8447_C1013", x7, cw7)):
        ok, e = close(apply_banded_general(xx, ww_), apply_banded_plain(xx, ww_))
        require(ok, f"smooth_general ({name}) differs from its plain version (max {e})")
        g_awkward[name] = e
    xs = xc[:1013]
    ys = apply_banded_plain(xs, cw)
    for ldy in (G + 4, G + 5):
        yp = torch.full((xs.shape[0], ldy), float("inf"), device=dev)
        with torch.cuda.device(dev):
            rc = _build.library().ic_smooth_general(
                *cw.general_args(xs), _build.ptr(yp), ldy, xs.shape[0], G,
                cw.halfband4, _build.stream_of(xs))
        _build.check(rc, "smooth_general")
        ok, e = close(yp[:, :G], ys)
        require(ok and bool(torch.isinf(yp[:, G:]).all()),
                f"smooth_general (ldy {ldy}) differs or wrote its padding (max {e})")
        g_awkward[f"ldy_{ldy}"] = e
    del cw7, x7, xs, ys, yp
    nnz_c = int((cw.band != 0).sum())
    Wc = cw.dense()
    rows["smooth_general"] = dict(
        max_abs_err=err, max_abs_err_wide_genome=err_w,
        max_abs_err_bf16_weights=err_b, awkward_max_abs_err=g_awkward,
        ms=time_ms(lambda: apply_banded_general(xc, cw)),
        ms_wide_genome=time_ms(lambda: apply_banded_general(xw, ww)),
        plain_ms=time_ms(lambda: apply_banded_plain(xc, cw), reps=3),
        library_ms=time_ms(lambda: torch.matmul(xc, Wc), reps=3),
        bound=bound(2 * xc.numel() * 4 + cw.band4.numel() * 4,
                    2.0 * nnz_c * CHUNK),
        bound_ms_wide_genome=bound(2 * xw.numel() * 4 + ww.band4.numel() * 4,
                                   2.0 * int((ww.band != 0).sum()) * WIDE_CHUNK)[0],
        band_nonzeros=nnz_c, shape=list(xc.shape),
        shape_wide_genome=list(xw.shape))
    del Wc, xc, xw

    # ---- kernel 7: row median of the coordinates smooth [32768, 8448] ---
    mk = row_median(yc)
    require(bits_equal(mk, row_median_plain(yc)),
            "row_median differs from its plain version")
    require(bits_equal(row_median(yw[:1024]), row_median_plain(yw[:1024])),
            f"row_median ({WIDE_GENES} genes, row not staged) differs")
    edge = torch.randint(-3, 4, (64, 1001), generator=gen, device=dev).float()
    edge[0, :3] = float("inf")
    edge[1, :600] = -float("inf")
    edge[2] = 0.0
    edge[3, ::2] = -0.0
    edge[4, :] = -0.0
    edge[5, :500] = float("inf")
    for e in (edge, edge[:, :1000]):      # odd and even widths
        require(bits_equal(row_median(e.contiguous()), row_median_plain(e)),
                "row_median differs on ties, infinities or -0")
    awkward_m = median_awkward(dev, yc, yw)
    for name, (xx, _n) in awkward_m.items():
        require(bits_equal(row_median(xx), row_median_plain(xx)),
                f"row_median ({name}) differs from its plain version")
    rows["row_median"] = dict(
        max_abs_err=0.0, bits_equal=True, awkward_bits_equal=sorted(awkward_m),
        plans={"coordinates": dataclasses.asdict(card_plan(G, G, dev)),
               "wide_genome": dataclasses.asdict(card_plan(WIDE_GENES, WIDE_GENES,
                                                           dev))},
        ms=time_ms(lambda: row_median(yc)),
        ms_wide_genome_row_not_staged=time_ms(lambda: row_median(yw)),
        plain_ms=time_ms(lambda: row_median_plain(yc), reps=3),
        library_ms=None,
        # torch.median returns the lower middle value: not the same function
        torch_median_lower_middle_ms_not_same_function=time_ms(
            lambda: torch.median(yc, dim=1)),
        bound=bound(yc.numel() * 4 + CHUNK * 4, 0.0),
        shape=list(yc.shape), shape_wide_genome=list(yw.shape))

    # ---- kernel 6: median-centred tail [8192, 60000] --------------------
    g2 = [win.mr.amin(0).contiguous(), win.mr.amax(0).contiguous()]
    o6, m6 = median_center_residual(yw, *g2, WIDE_GENES, with_median=True)
    p6, pm6 = median_center_residual_plain(yw, *g2, WIDE_GENES)
    ok, err = close(o6, p6)
    require(ok and bits_equal(m6, pm6), "median_center_residual differs from "
            f"its plain version (max {err})")
    del o6, p6
    c2 = [cin.mr.amin(0).contiguous(), cin.mr.amax(0).contiguous()]
    o6s = median_center_residual(yc, *c2, G)
    ok, err_s = close(o6s, median_center_residual_plain(yc, *c2, G)[0])
    require(ok, f"median_center_residual (row staged) differs (max {err_s})")
    # a padded smooth output (row stride G + 128; the padding is ignored)
    rows_p = min(1024, yc.shape[0])
    yp = torch.full((rows_p, G + 128), float("inf"), device=dev)
    yp[:, :G] = yc[:rows_p]
    o6p, m6p = median_center_residual(yp, *c2, G, with_median=True)
    p6p, pm6p = median_center_residual_plain(yp, *c2, G)
    ok, err_p = close(o6p, p6p)
    require(ok and bits_equal(m6p, pm6p) and bits_equal(o6p, o6s[:rows_p]),
            f"median_center_residual (padded rows) differs (max {err_p})")
    del o6s, yp, o6p, p6p
    # the awkward shapes of kernel 7, with bounds of their width (a padded
    # tensor passes its full rows, num_genes its width)
    g6 = {}
    for name, (xx, n) in awkward_m.items():
        lo, hi = ((c2 if n <= G else g2)[i][:n].contiguous() for i in (0, 1))
        yy = xx if xx.is_contiguous() else xx.as_strided(
            (xx.shape[0], xx.stride(0)), (xx.stride(0), 1))
        o, m = median_center_residual(yy, lo, hi, n, with_median=True)
        po, pm = median_center_residual_plain(yy, lo, hi, n)
        ok, e = close(o, po)
        require(ok and bits_equal(m, pm), f"median_center_residual ({name}) "
                f"differs from its plain version (max {e})")
        g6[name] = e
    del awkward_m
    rows["median_center_residual"] = dict(
        max_abs_err=err, max_abs_err_row_staged=err_s,
        max_abs_err_padded_rows=err_p, median_bits_equal=True,
        awkward_max_abs_err=g6,
        plans={"wide_genome": dataclasses.asdict(card_plan(WIDE_GENES, WIDE_GENES,
                                                           dev)),
               "8448": dataclasses.asdict(card_plan(G, G, dev))},
        ms=time_ms(lambda: median_center_residual(yw, *g2, WIDE_GENES)),
        ms_8448_row_staged=time_ms(lambda: median_center_residual(yc, *c2, G)),
        plain_ms=time_ms(lambda: median_center_residual_plain(yw, *g2, WIDE_GENES),
                         reps=3),
        library_ms=None,
        bound=bound(2 * yw.numel() * 4 + 2 * WIDE_GENES * 4, 0.0),
        shape=list(yw.shape))
    del yc, yw, mk, m6, pm6
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit(phase="kernels", **{k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                             for k, v in rows.items()})
    rows.update(ref_stats_phase(dev, smi, inp, ref_stats_routes(inp, cin, win, be)))
    path_launches = {}

    # ---- main path ------------------------------------------------------
    first_ms = warm_up(engine, inp)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ml, mr, noise = engine.ref_stats(ref_counts, nf, onehot_ref)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    resid, acc, states, spans = drive(engine, inp, N_ITER)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = path_launches["main_path"] = read_launches()
    for k in ("residual_fused", "log_norm", "ref_centred", "noise_rows", "viterbi"):
        require(launches[k] > 0, f"{k} was not launched on the main path")
    require(tuple(resid.shape) == (CHUNK, G) and bool(torch.isfinite(resid).all()),
            "main path residual is not finite or has the wrong shape")
    require(bool((acc[1] == N_ITER * CHUNK // N_SUB).all()), "subcluster counts")
    calls = called(states, go, N_SUB // 2, neutral=3)
    require_calls(calls, "main path")
    cells = N_ITER * CHUNK
    emit(phase="main_path", card=smi, launches=launches,
         ref_stats_ms=(t1 - t0) * 1e3, chunks_ms=(t2 - t1) * 1e3,
         chunk_ms=(t2 - t1) * 1e3 / N_ITER, warm_up_2_chunks_ms=first_ms,
         chunk_span_ms=span_ms(spans),
         cells=cells, cells_per_s=cells / (t2 - t1), called=calls)
    del resid

    # ---- mesh_engine: the main path's engine over two shards of the card
    torch.cuda.empty_cache()
    mesh_engine_phase(dev, smi, inp)
    torch.cuda.empty_cache()

    # ---- coordinate smoothing with the i3 HMM ---------------------------
    first_ms = warm_up(cin.engine, cin)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c_stats = cin.engine.ref_stats(cin.ref_counts, cin.nf, cin.onehot_ref)
    h3 = i3_hmm_params(cin.engine.transform_chunk(cin.ref_counts, cin.nf,
                                                  *c_stats[:2]), ref_groups, [])
    e3 = CnvEngine(hgo, h3, cin.config, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    c_inp = types.SimpleNamespace(**{**vars(cin), "ml": c_stats[0],
                                     "mr": c_stats[1], "noise": c_stats[2]})
    resid, acc, states, spans = drive(e3, c_inp, N_ITER)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = path_launches["coords_i3_path"] = read_launches()
    for k in ("smooth_general", "row_median", "viterbi"):
        require(launches[k] > 0, f"{k} was not launched on the coordinates path")
    require(tuple(resid.shape) == (CHUNK, G) and bool(torch.isfinite(resid).all()),
            "coordinates path residual is not finite or has the wrong shape")
    require(tuple(states.shape) == (N_SUB, G) and int(states.max()) <= 3,
            "coordinates path: the group-mean states are not i3 states")
    calls = called(states, hgo, N_SUB // 2, neutral=2)
    require_calls(calls, "coordinates + i3 path")
    emit(phase="coords_i3_path", card=smi, launches=launches,
         halfband=cw.halfband, side_tiles=cw.side_tiles,
         i3_means=[float(v) for v in h3.means], i3_sd=float(h3.sds[0]),
         setup_ms=(t1 - t0) * 1e3, chunks_ms=(t2 - t1) * 1e3,
         chunk_ms=(t2 - t1) * 1e3 / N_ITER, warm_up_2_chunks_ms=first_ms,
         chunk_span_ms=span_ms(spans),
         cells=cells, cells_per_s=cells / (t2 - t1), called=calls)
    del resid

    # ---- a genome too wide for the fused kernel -------------------------
    we = win.engine
    first_ms = warm_up(we, win)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w_stats = we.ref_stats(win.ref_counts, win.nf, win.onehot_ref)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    w_inp = types.SimpleNamespace(**{**vars(win), "ml": w_stats[0],
                                     "mr": w_stats[1], "noise": w_stats[2]})
    resid, acc, states, spans = drive(we, w_inp, N_SHORT_ITER)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = path_launches["wide_genome_path"] = read_launches()
    for k in ("smooth_general", "median_center_residual", "viterbi"):
        require(launches[k] > 0, f"{k} was not launched on the wide-genome path")
    require(tuple(resid.shape) == (WIDE_CHUNK, WIDE_GENES)
            and bool(torch.isfinite(resid).all()),
            "wide-genome residual is not finite or has the wrong shape")
    calls = called(states, wgo, N_SUB // 2, neutral=3)
    require_calls(calls, "wide-genome path")
    w_cells = N_SHORT_ITER * WIDE_CHUNK
    emit(phase="wide_genome_path", card=smi, launches=launches,
         genes=WIDE_GENES, ref_stats_ms=(t1 - t0) * 1e3,
         chunks_ms=(t2 - t1) * 1e3, chunk_ms=(t2 - t1) * 1e3 / N_SHORT_ITER,
         warm_up_2_chunks_ms=first_ms,
         chunk_span_ms=span_ms(spans), cells=w_cells,
         cells_per_s=w_cells / (t2 - t1), called=calls)
    del resid, w_inp

    # ---- the bf16 smooth ------------------------------------------------
    first_ms = warm_up(be, inp)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b_stats = be.ref_stats(ref_counts, nf, onehot_ref)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    b_inp = types.SimpleNamespace(**{**vars(inp), "ml": b_stats[0],
                                     "mr": b_stats[1], "noise": b_stats[2]})
    resid, acc, states, spans = drive(be, b_inp, N_SHORT_ITER)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = path_launches["bf16_path"] = read_launches()
    for k in ("ref_centred", "residual_fused_bf16", "viterbi"):
        require(launches[k] > 0, f"{k} was not launched on the bf16 path")
    calls = called(states, go, N_SUB // 2, neutral=3)
    require_calls(calls, "bf16 path")
    # the f32 engine on the same two chunks
    _, _, states_f32, _ = drive(engine, inp, N_SHORT_ITER)
    same = torch.equal(states, states_f32)
    require(same, "bf16 path: the states differ from the f32 engine's")
    b_cells = N_SHORT_ITER * CHUNK
    emit(phase="bf16_path", card=smi, launches=launches,
         ref_stats_ms=(t1 - t0) * 1e3, chunks_ms=(t2 - t1) * 1e3,
         chunk_ms=(t2 - t1) * 1e3 / N_SHORT_ITER, warm_up_2_chunks_ms=first_ms,
         chunk_span_ms=span_ms(spans),
         cells=b_cells, cells_per_s=b_cells / (t2 - t1), called=calls,
         states_equal_f32=same)
    del resid, b_inp

    # ---- reference: the default engine on 512 cells, card against CPU --
    cpu = CnvEngine(go, hmm, inp.config, device="cpu")
    few = counts_a[:N_CHECK]
    oh_few = onehot[:, :N_CHECK]
    stats_c = cpu.ref_stats(ref_counts.cpu(), nf, onehot_ref.cpu())
    for a, b in zip((ml, mr, noise), stats_c):
        require(torch.allclose(a.cpu(), b, rtol=1e-5, atol=1e-6),
                "ref_stats: card and CPU disagree")
    tr_g = engine.transform_chunk(few, nf, ml, mr)
    tr_c = cpu.transform_chunk(few.cpu(), nf, ml.cpu(), mr.cpu())
    ok, err = close(tr_g.cpu(), tr_c)
    require(ok, f"transform_chunk: card and CPU disagree (max {err})")
    _, gs_g, gc_g = engine.subcluster_chunk(few, nf, ml, mr, noise, oh_few)
    _, gs_c, gc_c = cpu.subcluster_chunk(few.cpu(), nf, ml.cpu(), mr.cpu(),
                                         noise.cpu(), oh_few.cpu())
    require(torch.allclose(gs_g.cpu(), gs_c, rtol=1e-4, atol=1e-2),
            "subcluster sums: card and CPU disagree")
    gmc = gs_c / gc_c[:, None]
    same = torch.equal(engine.viterbi_group_means(gmc.to(dev)).cpu(),
                       cpu.viterbi_group_means(gmc))
    require(same, "viterbi_group_means: card and CPU states differ")
    emit(phase="reference", cells=N_CHECK, transform_max_abs_err=err,
         states_equal=same)

    # ---- coords_reference: coordinates + i3 on 512 cells, card vs CPU ---
    cpu3 = CnvEngine(hgo, h3, cin.config, device="cpu")
    few = cin.counts_a[:N_CHECK]
    cstats = [t.cpu() for t in c_stats]
    for a, b in zip(c_stats, cpu3.ref_stats(cin.ref_counts.cpu(), cin.nf,
                                            cin.onehot_ref.cpu())):
        require(torch.allclose(a.cpu(), b, rtol=1e-5, atol=1e-6),
                "coordinates ref_stats: card and CPU disagree")
    tr_g = e3.transform_chunk(few, cin.nf, *c_stats[:2]).cpu()
    tr_c = cpu3.transform_chunk(few.cpu(), cin.nf, *cstats[:2])
    ok, err = close(tr_g, tr_c)
    require(ok, f"coordinates transform_chunk: card and CPU disagree (max {err})")
    fr_g, fs_g = e3.full_chunk(few, cin.nf, *c_stats)
    fr_c, fs_c = cpu3.full_chunk(few.cpu(), cin.nf, *cstats)
    states_same = torch.equal(fs_g.cpu(), fs_c)
    require(states_same, "coordinates full_chunk: card and CPU states differ")
    # denoised values agree except where the residual sits within the
    # tolerance of a denoise threshold (either side may then be taken)
    mean_ref, spread = float(cstats[2][0]), float(cstats[2][1])
    near = torch.minimum((tr_c - (mean_ref - spread)).abs(),
                         (tr_c - (mean_ref + spread)).abs()) \
        <= RESID_TOL + RESID_TOL * tr_c.abs()
    d_ok = ((fr_g.cpu() - fr_c).abs() <= RESID_TOL + RESID_TOL * fr_c.abs()) | near
    require(bool(d_ok.all()), "coordinates full_chunk: denoised residuals differ")
    oh_few = cin.onehot[:, :N_CHECK]
    _, gs_g, _ = e3.subcluster_chunk(few, cin.nf, *c_stats, oh_few)
    _, gs_c, gc_c = cpu3.subcluster_chunk(few.cpu(), cin.nf, *cstats, oh_few.cpu())
    require(torch.allclose(gs_g.cpu(), gs_c, rtol=1e-4, atol=1e-2),
            "coordinates subcluster sums: card and CPU disagree")
    gmc = gs_c / gc_c[:, None]
    same = torch.equal(e3.viterbi_group_means(gmc.to(dev)).cpu(),
                       cpu3.viterbi_group_means(gmc))
    require(same, "coordinates viterbi_group_means: card and CPU states differ")
    emit(phase="coords_reference", cells=N_CHECK, transform_max_abs_err=err,
         full_chunk_states_equal=states_same, group_states_equal=same)

    # ---- host_syncs: the program's counter against the sync-debug mode ----
    host_syncs_phase(smi, inp, e3, cin, c_stats)

    # ---- run(): the pipeline around the engine ---------------------------
    del inp, cin, win, be, counts_a, counts_b, ref_counts
    torch.cuda.empty_cache()
    bayes_sampler(dev, smi)
    runs_dir = ROOT / "build" / "chip_smoke_runs"
    shutil.rmtree(runs_dir, ignore_errors=True)
    run_launches = run_phases(dev, smi, runs_dir)

    # ---- kernel table, card, result ------------------------------------
    table = []
    for name, (src, replaces, phase) in KERNELS.items():
        r = rows[name]
        b_ms, b_by = r["bound"]
        table.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                          launches=path_launches[phase][name], launch_phase=phase,
                          run_launches={k: v[name] for k, v in run_launches.items()},
                          max_abs_err=r["max_abs_err"], ms=r["ms"],
                          plain_ms=r["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                          library_ms=r["library_ms"]))
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    workers = {"--worker": worker, "--scale-worker": scale_worker,
               "--program-worker": program_worker}
    if sys.argv[1:2] and sys.argv[1] in workers:
        try:
            return workers[sys.argv[1]](sys.argv[2:])
        except Check as e:
            return fail(str(e))
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False; this script needs a CUDA card")
    if not (ROOT / "infercnv_tpu_torch" / "csrc").is_dir():
        return fail(f"infercnv_tpu_torch is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    try:
        if sys.argv[1:2] == ["--ref-stats"]:
            return ref_stats_only(torch.device("cuda", 0))
        return run(torch.device("cuda", 0))
    except Check as e:
        return fail(str(e))


if __name__ == "__main__":
    sys.exit(main())
