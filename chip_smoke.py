#!/usr/bin/env python3
"""Smoke run of infercnv_tpu_torch on one CUDA card.

    python3 chip_smoke.py          (from the root of the repository)

Phases, each printing one JSON line:
  device     the card (nvidia-smi name and power limit), CUDA, TF32 flags
  build      nvcc builds the kernels from infercnv_tpu_torch/csrc
  kernels    each CUDA kernel against its plain PyTorch version on the card,
             at the main path's shapes, with times (CUDA events)
  main_path  the bench workload on the port: 8448 genes on 22 chromosomes,
             u16 counts, 32768-cell chunks, 256 reference cells in 2 groups,
             16 subclusters with a planted 0.5x loss on chr2 and 2x gain on
             chr5 in subclusters 8-15: ref_stats, 12 subcluster_chunk calls
             with accumulation, viterbi_group_means; every kernel's launch
             count must rise and the planted CNVs must be called
  reference  the same path on 512 cells, the card against the CPU
Then the kernel table as one JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failure exits non-zero before that line;
without a CUDA device, or without the package beside this file, it exits
non-zero at once.
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


def bench_genome():
    """bench.py's genome: 8448 genes on 22 chromosomes."""
    import numpy as np

    from infercnv_tpu_torch.core.genome import GeneOrder

    sizes = np.linspace(800, 120, 22).astype(int)
    sizes = (sizes / sizes.sum() * 8448).astype(int)
    sizes[0] += 8448 - sizes.sum()
    G = int(sizes.sum())
    return GeneOrder(names=tuple(f"g{i}" for i in range(G)),
                     chr_names=tuple(f"chr{i + 1}" for i in range(22)),
                     chr_ids=np.repeat(np.arange(22), sizes).astype(np.int32),
                     start=np.arange(G), stop=np.arange(G))


def make_counts(lam, gen):
    """Poisson counts as u16 (drawn on the card; every value < 2^15)."""
    import torch

    c = torch.poisson(lam, generator=gen)
    return c.clamp_(max=32767).to(torch.int16).view(torch.uint16)


def make_inputs(dev):
    """The main path's workload, made from SEED on the card: bench.py's
    genome and HMM, the default engine, two u16 count chunks with the planted
    loss (chr2) and gain (chr5) in subclusters N_SUB/2.., the reference
    cells in 2 groups, the subcluster membership, and the reference
    statistics with the residual kernel's four bound rows."""
    import types

    import numpy as np
    import torch

    from infercnv_tpu_torch.models.hmm import HMMParams
    from infercnv_tpu_torch.ops.residual_fused import counts_to_f32
    from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig

    go = bench_genome()
    G = go.num_genes
    hmm = HMMParams(means=np.array([0.135, 0.631, 1.0, 1.346, 1.702, 2.237]),
                    sds=np.array([0.221, 0.252, 0.211, 0.288, 0.341, 0.457]),
                    t=1e-6)
    engine = CnvEngine(go, hmm, EngineConfig(denoise=True, sd_amplifier=1.5),
                       device=dev)
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gene_means = torch.tensor(rng.gamma(2.0, 30.0, G), dtype=torch.float32,
                              device=dev)
    labels = torch.arange(CHUNK, device=dev) % N_SUB
    lam = gene_means[None, :].repeat(CHUNK, 1)
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
    onehot = torch.zeros((N_SUB, CHUNK), device=dev)
    onehot[labels, torch.arange(CHUNK, device=dev)] = 1
    ml, mr, noise = engine.ref_stats(ref_counts, nf, onehot_ref)
    bounds = [ml.amin(0).contiguous(), ml.amax(0).contiguous(),
              mr.amin(0).contiguous(), mr.amax(0).contiguous()]
    torch.cuda.synchronize()
    return types.SimpleNamespace(
        go=go, hmm=hmm, engine=engine, gen=gen, counts_a=counts_a,
        counts_b=counts_b, ref_counts=ref_counts, nf=nf,
        onehot_ref=onehot_ref, onehot=onehot, ml=ml, mr=mr, noise=noise,
        bounds=bounds)


def counters():
    from infercnv_tpu_torch.ops import residual_fused, smoothing, viterbi_kernel

    return {"residual_fused": residual_fused, "smooth_banded": smoothing,
            "viterbi": viterbi_kernel}


def run(dev) -> int:
    import numpy as np
    import torch

    from infercnv_tpu_torch.ops import _build
    from infercnv_tpu_torch.ops.residual_fused import (
        counts_to_f32, denoise, residual_fused, residual_fused_plain)
    from infercnv_tpu_torch.ops.smoothing import apply_banded, apply_banded_plain
    from infercnv_tpu_torch.ops.viterbi_kernel import (
        transition_logs, viterbi, viterbi_plain)
    from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig

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

    def close(got, want):
        err = (got.float() - want.float()).abs()
        ok = bool((err <= RESID_TOL + RESID_TOL * want.float().abs()).all())
        return ok, float(err.max())

    rows = {}

    # ---- kernel 3: banded smooth [256, 8448] ---------------------------
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
    # The main path runs the variant with the denoised second output (its
    # residual equals the f32 one above bit for bit, and the denoised output
    # equals denoise() of it), so the row's time and bound are that
    # variant's: the counts in, two f32 outputs, the band and bound rows.
    c_bytes = counts_a.numel() * 2 + w.band.numel() * 4 + 4 * G * 4
    rows["residual_fused"] = dict(
        max_abs_err=err, variants_max_abs_err=variants,
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

    # ---- kernel 2: Viterbi, subcluster (B = 208) and cells mode --------
    lay = engine._layout
    S = hmm.num_states
    log_diag, log_off, log_delta = transition_logs(S, hmm.t)
    gather = torch.as_tensor(lay.gather, dtype=torch.int64, device=dev)
    n_bins, L = gather.shape
    lens_bin = torch.as_tensor(lay.valid.sum(axis=1), dtype=torch.int32, device=dev)
    bnd_bin = torch.as_tensor(lay.boundaries, device=dev)

    def packed(resid, sig):
        C = resid.shape[0]
        return (resid[:, gather].reshape(C * n_bins, L), lens_bin.repeat(C),
                torch.full((C * n_bins,), sig, device=dev), bnd_bin.repeat(C, 1))

    r32 = rk[torch.float32]
    gm = (onehot @ r32) / onehot.sum(dim=1, keepdim=True)
    sigma = float(np.float32(np.median(hmm.sds)))
    args_sub = packed(gm, sigma)
    args_cells = packed(r32[:4096], sigma)
    vit = {}
    for mode, args in (("subclusters", args_sub), ("cells_4096", args_cells)):
        sk = viterbi(*args, hmm.means, log_delta, log_diag, log_off)
        sp = viterbi_plain(*args, hmm.means, log_delta, log_diag, log_off)
        require(torch.equal(sk, sp), f"viterbi ({mode}) states differ from the plain version")
        vit[mode] = args
    del args_cells
    B = args_sub[0].shape[0]
    valid_positions = int(args_sub[1].sum())
    v_bytes = B * L * (4 + 1 + 1) + B * 8
    args_full = packed(r32, sigma)
    ms_full = time_ms(lambda: viterbi(*args_full, hmm.means, log_delta, log_diag,
                                      log_off), reps=3)
    del args_full
    rows["viterbi"] = dict(
        max_abs_err=0.0, states_equal=True,
        ms=time_ms(lambda: viterbi(*args_sub, hmm.means, log_delta, log_diag, log_off)),
        ms_cells_mode_full_chunk=ms_full,
        plain_ms=time_ms(lambda: viterbi_plain(*args_sub, hmm.means, log_delta,
                                               log_diag, log_off), reps=3),
        library_ms=None,
        bound=bound(v_bytes, float(VITERBI_FLOPS) * valid_positions * S),
        shape=[B, L])
    del rk, r32, vit
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit(phase="kernels", **{k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                             for k, v in rows.items()})

    # ---- main path ------------------------------------------------------
    mods = counters()
    for m in mods.values():
        m.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ml, mr, noise = engine.ref_stats(ref_counts, nf, onehot_ref)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    acc = None
    for i in range(N_ITER):
        resid, *acc = engine.subcluster_chunk(
            counts_a if i % 2 == 0 else counts_b, nf, ml, mr, noise, onehot,
            acc=acc)
    states = engine.viterbi_group_means(acc[0] / acc[1][:, None])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k: m.LAUNCHES for k, m in mods.items()}
    for k, n in launches.items():
        require(n > 0, f"{k} was not launched on the main path")
    require(tuple(resid.shape) == (CHUNK, G) and bool(torch.isfinite(resid).all()),
            "main path residual is not finite or has the wrong shape")
    require(bool((acc[1] == N_ITER * CHUNK // N_SUB).all()), "subcluster counts")
    st = states.cpu().numpy()
    c2, c5 = go.chr_gene_indices("chr2"), go.chr_gene_indices("chr5")
    half = N_SUB // 2
    del_frac = float((st[half:][:, c2] < 3).mean())
    amp_frac = float((st[half:][:, c5] > 3).mean())
    neutral = float((st[:half] == 3).mean())
    require(del_frac > 0.7 and amp_frac > 0.7 and neutral > 0.9,
            f"planted CNVs not called: del {del_frac} amp {amp_frac} neutral {neutral}")
    cells = N_ITER * CHUNK
    emit(phase="main_path", card=smi, launches=launches,
         ref_stats_ms=(t1 - t0) * 1e3, chunks_ms=(t2 - t1) * 1e3,
         chunk_ms=(t2 - t1) * 1e3 / N_ITER, cells=cells,
         cells_per_s=cells / (t2 - t1),
         called={"del_chr2": del_frac, "amp_chr5": amp_frac,
                 "neutral_0_7": neutral},
         per_subcluster_min={
             "del_chr2": float((st[half:][:, c2] < 3).mean(axis=1).min()),
             "amp_chr5": float((st[half:][:, c5] > 3).mean(axis=1).min())})

    # ---- reference: the same path on 512 cells, card against CPU --------
    cpu = CnvEngine(go, hmm, EngineConfig(denoise=True, sd_amplifier=1.5),
                    device="cpu")
    few = counts_a[:512]
    oh_few = onehot[:, :512]
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
    emit(phase="reference", cells=512, transform_max_abs_err=err, states_equal=same)

    # ---- kernel table, card, result ------------------------------------
    meta = {
        "residual_fused": ("infercnv_tpu_torch/csrc/residual_fused.cu",
                           "infercnv_tpu/ops/residual_fused.py:95"),
        "viterbi": ("infercnv_tpu_torch/csrc/viterbi.cu",
                    "infercnv_tpu/ops/viterbi_pallas.py:77"),
        "smooth_banded": ("infercnv_tpu_torch/csrc/smooth_banded.cu",
                          "infercnv_tpu/ops/smoothing.py:74"),
    }
    table = []
    for name, (src, replaces) in meta.items():
        r = rows[name]
        b_ms, b_by = r["bound"]
        table.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                          launches=launches[name], max_abs_err=r["max_abs_err"],
                          ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b_ms,
                          bound_by=b_by, library_ms=r["library_ms"]))
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
