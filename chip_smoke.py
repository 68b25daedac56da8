#!/usr/bin/env python3
"""Smoke run of infercnv_tpu_torch on one CUDA card.

    python3 chip_smoke.py          (from the root of the repository)

Phases, each printing one JSON line:
  device      the card (nvidia-smi name and power limit), CUDA, TF32 flags
  build       nvcc builds the kernels from infercnv_tpu_torch/csrc
  routes      the route each path's engine takes (residual and smooth), and
              the coordinates band (halfband, nonzeros, taps a tile)
  kernels     each CUDA kernel against its plain PyTorch version on the card,
              at the shapes its path gives it, with times (CUDA events)
  main_path   the bench workload on the port: 8448 genes on 22 chromosomes,
              u16 counts, 32768-cell chunks, 256 reference cells in 2 groups,
              16 subclusters with a planted 0.5x loss on chr2 and 2x gain on
              chr5 in subclusters 8-15: ref_stats, 12 subcluster_chunk calls
              with accumulation, viterbi_group_means; the fused residual,
              smooth and Viterbi kernels must be launched and the planted
              CNVs called
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
              bf16 smooth and the fused kernel's bf16 variant run, and the
              group-mean states equal the f32 engine's on the same chunks
  reference   the default engine on 512 cells, the card against the CPU
  coords_reference  the coordinates + i3 engine on 512 cells, the card
              against the CPU, full_chunk included
Each path phase runs two warm-up chunks, then sets every launch count to 0
just before it and reads them just after; besides its wall-clock rate it
reports the chunks' mean device span (CUDA events).  Then the kernel table as one JSON line, the nvidia-smi line, and
last {"ok": true, "device": {...}}.  Any failure exits non-zero before that
line; without a CUDA device, or without the package beside this file, it
exits non-zero at once.
"""

from __future__ import annotations

import json
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
#: GRCh38 chromosome lengths, chr1..chr22, in Mbp
GRCH38_MBP = (248.96, 242.19, 198.30, 190.21, 181.54, 170.81, 159.35, 145.14,
              138.39, 133.80, 135.09, 133.28, 114.36, 107.04, 101.99, 90.34,
              83.26, 80.37, 58.62, 64.44, 46.71, 50.82)
#: approximate protein-coding gene counts per chromosome (relative weights)
PROTEIN_CODING = (2050, 1300, 1080, 750, 880, 1040, 920, 690, 780, 730, 1310,
                  1030, 320, 610, 600, 850, 1180, 270, 1470, 540, 230, 440)


def emit(**kv):
    print(json.dumps(kv), flush=True)


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
    from infercnv_tpu_torch.ops import median, residual_fused, smoothing, viterbi_kernel

    return {"residual_fused": (residual_fused, "LAUNCHES"),
            "residual_fused_bf16": (residual_fused, "LAUNCHES_BF16"),
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
    from infercnv_tpu_torch.ops.viterbi_kernel import (
        transition_logs, viterbi, viterbi_plain)
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
    x = torch.randn((N_REF, G), generator=gen, device=dev)
    yk = apply_banded(x, w)
    yp = apply_banded_plain(x, w)
    torch.cuda.synchronize()
    ok, err = close(yk, yp)
    require(ok, f"smooth_banded differs from its plain version (max {err})")
    W = w.dense()
    rows["smooth_banded"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: apply_banded(x, w)),
        plain_ms=time_ms(lambda: apply_banded_plain(x, w)),
        library_ms=time_ms(lambda: torch.matmul(x, W)),
        bound=bound(2 * x.numel() * 4 + w.band.numel() * 4, 2.0 * nnz * N_REF),
        shape=list(x.shape))
    del W
    wb = be._w_smooth
    yk4 = apply_banded(x, wb)
    ok, err = close(yk4, apply_banded_plain(x, wb), tol=1e-5)
    require(ok, f"smooth_banded_bf16 differs from its plain version (max {err})")
    # bf16 keeps 8 significant bits: each product moves by at most
    # (2u + u^2) of |w||x|, u = 2^-8 (plus the f32 sums)
    diff = (yk4 - yk).abs()
    rb = (2.0 ** -7 + 2.0 ** -16) * apply_banded(x.abs(), w) + 1e-6
    require(bool((diff <= rb).all()), "smooth_banded_bf16: beyond the bf16 "
            f"rounding bound of the f32 smooth (max {float(diff.max())})")
    rows["smooth_banded_bf16"] = dict(
        max_abs_err=err, max_abs_diff_from_f32=float(diff.max()),
        max_diff_from_f32_over_max_f32=float(diff.max() / yk.abs().max()),
        ms=time_ms(lambda: apply_banded(x, wb)),
        plain_ms=time_ms(lambda: apply_banded_plain(x, wb)),
        library_ms=None,
        bound=bound(2 * x.numel() * 4 + wb.band.numel() * 4,
                    2.0 * int((wb.band != 0).sum()) * N_REF),
        shape=list(x.shape))
    del x, yk, yp, yk4, diff, rb

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

    # ---- kernel 2: Viterbi, subcluster (B = 208) and cells mode, i6 and i3
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

    def check_viterbi(hmm_, packed, resid, what):
        log_diag, log_off, log_delta = transition_logs(hmm_.num_states, hmm_.t)
        sigma = float(np.float32(np.median(hmm_.sds)))
        gm = (onehot @ resid) / onehot.sum(dim=1, keepdim=True)
        args_sub = packed(gm, sigma)
        for mode, args in (("subclusters", args_sub),
                           ("cells_4096", packed(resid[:4096], sigma))):
            sk = viterbi(*args, hmm_.means, log_delta, log_diag, log_off)
            sp = viterbi_plain(*args, hmm_.means, log_delta, log_diag, log_off)
            require(torch.equal(sk, sp),
                    f"viterbi ({what}, {mode}) states differ from the plain version")
        return args_sub, (hmm_.means, log_delta, log_diag, log_off)

    r32 = rk[torch.float32]
    packed6 = packer(engine._layout)
    args_sub, hargs = check_viterbi(hmm, packed6, r32, "i6")
    S = hmm.num_states
    B, L = args_sub[0].shape
    valid_positions = int(args_sub[1].sum())
    v_bytes = B * L * (4 + 1 + 1) + B * 8
    args_full = packed6(r32, float(args_sub[2][0]))
    ms_full = time_ms(lambda: viterbi(*args_full, *hargs), reps=3)
    del args_full, rk, r32
    # i3 (S = 3): the coordinates engine's residual and the i3 parameters
    # from its transformed reference cells
    ref_groups = [np.arange(N_REF // 2), np.arange(N_REF // 2, N_REF)]
    h3 = i3_hmm_params(cin.engine.transform_chunk(cin.ref_counts, cin.nf, cin.ml,
                                                  cin.mr), ref_groups, [])
    rc = cin.engine.transform_chunk(cin.counts_a, cin.nf, cin.ml, cin.mr)
    args_sub3, hargs3 = check_viterbi(h3, packer(cin.engine._layout), rc, "i3")
    del rc
    rows["viterbi"] = dict(
        max_abs_err=0.0, states_equal=True, states_equal_i3=True,
        ms=time_ms(lambda: viterbi(*args_sub, *hargs)),
        ms_i3_subclusters=time_ms(lambda: viterbi(*args_sub3, *hargs3)),
        shape_i3_subclusters=list(args_sub3[0].shape),
        ms_cells_mode_full_chunk=ms_full,
        plain_ms=time_ms(lambda: viterbi_plain(*args_sub, *hargs), reps=3),
        library_ms=None,
        bound=bound(v_bytes, float(VITERBI_FLOPS) * valid_positions * S),
        shape=[B, L])

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
    for k in ("residual_fused", "smooth_banded", "viterbi"):
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
    for k in ("smooth_banded_bf16", "residual_fused_bf16", "viterbi"):
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

    # ---- kernel table, card, result ------------------------------------
    table = []
    for name, (src, replaces, phase) in KERNELS.items():
        r = rows[name]
        b_ms, b_by = r["bound"]
        table.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                          launches=path_launches[phase][name], launch_phase=phase,
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
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False; this script needs a CUDA card")
    if not (ROOT / "infercnv_tpu_torch" / "csrc").is_dir():
        return fail(f"infercnv_tpu_torch is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    try:
        return run(torch.device("cuda", 0))
    except Check as e:
        return fail(str(e))


if __name__ == "__main__":
    sys.exit(main())
