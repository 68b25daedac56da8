#!/usr/bin/env python3
"""What limits the fused residual, the smooths, the median kernels and the
Viterbi, on one CUDA card.

    python3 benchmarks/torch_kernel_variants.py [section ...]
                                            (from the repository root)

Sections (all by default): residual_fused, smooth_general, median,
median_plans, smooth_banded, viterbi.  Builds, beside the kernels as they
are, copies of their sources with one part taken out or done another way
(all builds in parallel), loads each build and times them in turns on
chip_smoke.py's workloads (CUDA events, median of 5, in the order built,
variants, variants, built; calls of tens of microseconds by graph_ms):

  residual_fused  as built; "constant_bound_rows": the four bound rows read
                  as constants (their loads from L2 gone); "select_vote":
                  the select's warp vote on (its row type's kVote).  Median
                  with the denoised output, and mean centring without the
                  smooth.
  smooth_general  as built; "without_fmas": the tap loop skipped (staging,
                  barriers and stores remain).  Coordinates [32768, 8448]
                  and 60,000 genes [8192, 60000].
  median          as built; "copy_only": the select taken out (the rows'
                  copies into shared memory, their waits and the tail's
                  stores remain); "no_vote": the row type's kVote off (the
                  warp vote, and with it the select's lean histogram
                  handling: rotated reads, shuffle scan, clearing).  The row
                  median (kernel 7) and the median tail (kernel 6) on the
                  smooth outputs of the coordinates chunk [32768, 8448] and
                  of 60,000 genes [8192, 60000].
  median plans    the same kernels as built under other launch plans
                  (ops/median.py median_plan's overrides: threads and
                  blocks an SM), timed in turns with the plan, at 8448 and
                  60,000 genes.
  smooth_banded   as built (a row split over blocks, a span of 1024
                  coordinates each; 4 rows a block with bf16 weights);
                  "one_block_a_row": one block walks the spans of its rows
                  in turn; "loads_and_stores_only":
                  the items taken out (the window's loads, the general
                  genes and the stores remain).  [256, 8448] and [16384,
                  8448], f32 and bf16 weights.
  viterbi         the latency regime as built; "emissions_on_chain": the
                  consumer also computes a step's emissions itself, on the
                  recursion's chain; "words_on_chain": the consumer also
                  forms each step's packed word (as the throughput regime
                  does) instead of leaving it to the packer warp;
                  "ring_without_emissions": the producers fill the ring
                  without computing emissions (the recursion alone, fed);
                  "producers_alone": the consumer takes the ring without
                  running the recursion; "no_backtrace".
                  B = 208, L = 678 and B = 160, L = 6460 (i6).  The
                  throughput regime as built and "byte_backpointers": a
                  step's S backpointer bytes stored to [L, S, B] and the
                  backtrace reading the byte of its state, as the earlier
                  kernel did; cells mode [425,984, 678] and B = 208.

A variant computes something else: its times say what the part it drops
costs, nothing more.  Prints one JSON line a kernel and the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "kernel_variants"

#: (source file, variant, text of the source, its replacement)
EDITS = [
    ("residual_fused.cu", "constant_bound_rows",
     "  const float lo = __ldg(p.b1min + g);\n  const float hi = __ldg(p.b1max + g);",
     "  const float lo = -0.05f, hi = 0.05f;"),
    ("residual_fused.cu", "constant_bound_rows",
     "  const float lo = __ldg(p.b2min + g);\n  const float hi = __ldg(p.b2max + g);",
     "  const float lo = -0.02f, hi = 0.02f;"),
    ("residual_fused.cu", "select_vote",
     "  static constexpr bool kVote = false;",
     "  static constexpr bool kVote = true;"),
    ("smooth_general.cu", "without_fmas",
     "        if (es == c0 && ee == c0 + kWChunk) {",
     "        if (false) {"),
    ("smooth_general.cu", "without_fmas",
     "          for (int e = es; e < ee; e += 4) taps4(e);",
     "          for (int e = es; e < 0; e += 4) taps4(e);"),
    ("median.cu", "copy_only",
     "      count_top(row, min(k * cq, row.ns), min((k + 1) * cq, row.ns),\n"
     "                sel->hist);\n",
     ""),
    ("median.cu", "copy_only",
     "    count_top(row, row.ns, row.slots(), sel->hist);\n"
     "    const float m = block_row_median(row, a.G, sel);",
     "    const float m = 0.0f;\n    __syncthreads();"),
    ("median.cu", "no_vote",
     "  static constexpr bool kVote = true;",
     "  static constexpr bool kVote = false;"),
    ("smooth_banded.cu", "one_block_a_row",
     "  smooth_span<kBf16>(x, bd, y, C, G, t4, blockIdx.x % bd.nspan,\n"
     "                     (blockIdx.x / bd.nspan) * R, vec,\n"
     "                     reinterpret_cast<float*>(smem4));",
     "  for (int k = 0; k < bd.nspan; ++k) {\n"
     "    smooth_span<kBf16>(x, bd, y, C, G, t4, k, blockIdx.x * R, vec,\n"
     "                       reinterpret_cast<float*>(smem4));\n"
     "    __syncthreads();\n  }"),
    ("smooth_banded.cu", "one_block_a_row",
     "  kern<<<static_cast<int>(grid), kSpanThreads, smem,",
     "  kern<<<static_cast<int>(grid / nspan), kSpanThreads, smem,"),
    ("smooth_banded.cu", "loads_and_stores_only", "  if (tid < nc) {", "  if (tid < 0) {"),
    ("smooth_banded.cu", "loads_and_stores_only",
     "  } else if (kBf16 && tid < nc + ns) {", "  } else if (kBf16 && tid < 0) {"),
    ("viterbi.cu", "emissions_on_chain",
     "    advance<S, kRestart>(nu, em, fl, p);",
     "    emissions<S>(em[0], 1.0f, p, em);\n"
     "    advance<S, kRestart>(nu, em, fl, p);"),
    ("viterbi.cu", "words_on_chain",
     "    advance<S, kRestart>(nu, em, fl, p);",
     "    log[(k + 1) * RingStride<S>::value - 1] =\n"
     "        __int_as_float(step<S>(nu, em, fl, p));"),
    ("viterbi.cu", "ring_without_emissions",
     "      float em[S];\n      emissions<S>(xv, sg, p, em);\n      const int r = c % ring;",
     "      float em[S];\n      for (int s = 0; s < S; ++s) em[s] = xv - p.means[s];\n"
     "      const int r = c % ring;"),
    ("viterbi.cu", "producers_alone",
     "        if (restarts[r])\n          forward_chunk<S, true>(nu, slot, log, p);\n"
     "        else\n          forward_chunk<S, false>(nu, slot, log, p);",
     "        nu[0] += slot[0];"),
    ("viterbi.cu", "no_backtrace",
     "  block_backtrace<S>(bp, st, maps, len, *last_state);", ""),
    ("viterbi.cu", "byte_backpointers",
     "      if (i > 0) bp[i * sB + b] = static_cast<uint16_t>(w);",
     "      if (i > 0) {\n"
     "        signed char* bb = reinterpret_cast<signed char*>(bp) + i * S * sB + b;\n"
     "        for (int s = 0; s < S; ++s) bb[s * sB] = static_cast<signed char>(back(w, s));\n"
     "      }"),
    ("viterbi.cu", "byte_backpointers",
     "      y = back(bp[(i + 1) * sB + b], y);",
     "      y = reinterpret_cast<const signed char*>(bp)[((i + 1) * S + y) * sB + b];"),
]


def build(source: str, variant: str | None, csrc: Path) -> ctypes.CDLL:
    """csrc's `source` (with the variant's edits) and common.cu as a library."""
    from infercnv_tpu_torch.ops import _build

    d = WORK / f"{Path(source).stem}_{variant or 'built'}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    text = (d / source).read_text()
    for src, var, old, new in EDITS:
        if src == source and var == variant:
            if old not in text:
                raise SystemExit(f"{source}: the text of variant {variant} is gone")
            text = text.replace(old, new)
    (d / source).write_text(text)
    lib_path = d / "lib.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-shared",
                    "-o", str(lib_path), str(d / source), str(d / "common.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, (args, res) in _build._SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    return lib


def build_all(wanted) -> dict:
    """{(source, variant): library} for every (source, variant), the nvcc
    processes in parallel."""
    csrc = ROOT / "infercnv_tpu_torch" / "csrc"
    with ThreadPoolExecutor(len(wanted)) as pool:
        libs = pool.map(lambda sv: build(sv[0], sv[1], csrc), wanted)
        return dict(zip(wanted, libs))


def in_turns(setups: dict, cases: dict, timer=None) -> dict:
    """Each case timed under each setup (a function that installs a
    variant), first, others, others, first; timer: chip_smoke.time_ms by
    default."""
    import chip_smoke as cs

    timer = timer or cs.time_ms
    names = list(setups)
    out = {n: {c: [] for c in cases} for n in names}
    for name in names + names[::-1]:
        setups[name]()
        for c, fn in cases.items():
            out[name][c].append(timer(fn))
    return out


def smooth_banded_section(dev, smi, setups):
    """The one-row smooth split over blocks against one block a row."""
    import torch

    import chip_smoke as cs
    from infercnv_tpu_torch.ops.layout import smoothing_operator
    from infercnv_tpu_torch.ops.smoothing import BandWeights, apply_banded

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    op = smoothing_operator(cs.bench_genome(), 101)
    w = {bf: BandWeights.from_operator(op, dev, bf16=bf) for bf in (False, True)}
    x = torch.randn((cs.N_REF, op.num_genes), generator=gen, device=dev)
    xl = torch.randn((cs.REF_CHUNK, op.num_genes), generator=gen, device=dev)
    small = in_turns(setups, {f"{k}_256": (lambda wt=wt: apply_banded(x, wt))
                              for k, wt in (("f32", w[False]), ("bf16", w[True]))},
                     timer=cs.graph_ms)
    large = in_turns(setups, {f"{k}_16384": (lambda wt=wt: apply_banded(xl, wt))
                              for k, wt in (("f32", w[False]), ("bf16", w[True]))})
    print(json.dumps({"kernel": "smooth_banded", "card": smi,
                      "shapes": [list(x.shape), list(xl.shape)],
                      "ms": {n: {**small[n], **large[n]} for n in small}}),
          flush=True)


def viterbi_section(dev, smi, setups, engine_lib):
    """The Viterbi's regimes with one part taken out or done another way,
    called through the C entry point (the byte backpointers need a scratch
    of S bytes a position, which the wrapper does not allocate)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from infercnv_tpu_torch.ops import _build
    from infercnv_tpu_torch.ops import viterbi_kernel as vk
    from infercnv_tpu_torch.ops.viterbi_pack import PackedLayout

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    hmm = cs.bench_hmm()
    S = hmm.num_states
    log_diag, log_off, log_delta = vk.transition_logs(S, hmm.t)
    means = np.ascontiguousarray(hmm.means, np.float32)
    delta = np.ascontiguousarray(log_delta, np.float32)
    sigma = float(np.float32(np.median(hmm.sds)))

    def laid(go, C, regime):
        """C rows of synthetic group means (a gain on the first eighth of
        the genes in half of them) packed as the engine packs them, laid
        out for the regime, with a plan and a scratch."""
        lay = PackedLayout.from_gene_order(go)
        gather = torch.as_tensor(lay.gather, dtype=torch.int64, device=dev)
        n_bins, L = gather.shape
        G = go.num_genes
        r = 1.0 + 0.2 * torch.randn((C, G), generator=gen, device=dev)
        r[C // 2:, :G // 8] += 0.6
        x = r[:, gather].reshape(C * n_bins, L)
        bnd = (torch.as_tensor(lay.boundaries, device=dev) != 0).to(torch.int8).repeat(C, 1)
        lens = torch.as_tensor(lay.valid.sum(axis=1), dtype=torch.int32,
                               device=dev).repeat(C)
        B = C * n_bins
        plan = vk.card_plan(B, L, S, dev, regime)
        out = torch.empty(x.shape, dtype=torch.int8, device=dev)
        bp = torch.empty(B * L * 8, dtype=torch.int8, device=dev)
        sig = torch.full((B,), sigma, device=dev)
        return (x.contiguous(), lens, sig, bnd.contiguous(), bp, out, B, L, plan)

    def call(a):
        x, lens, sig, bnd, bp, out, B, L, plan = a
        with torch.cuda.device(dev):
            rc = _build._library.ic_viterbi(
                _build.ptr(x), _build.ptr(lens), _build.ptr(sig), _build.ptr(bnd),
                _build.ptr(bp), _build.ptr(out), B, L, S, means.ctypes.data,
                delta.ctypes.data, float(np.float32(log_diag)),
                float(np.float32(log_off)), *plan.launch_args(),
                _build.stream_of(x))
        _build.check(rc, "viterbi")

    shapes = {"latency_B208_L678": laid(cs.bench_genome(), cs.N_SUB, "latency"),
              "latency_B160_L6460": laid(cs.human_like_genome(cs.WIDE_GENES),
                                         cs.N_SUB, "latency"),
              "throughput_B208_L678": laid(cs.bench_genome(), cs.N_SUB, "throughput"),
              "throughput_cells_mode": laid(cs.bench_genome(), cs.CHUNK,
                                            "throughput")}
    latency = {k: v for k, v in setups.items() if k != "byte_backpointers"}
    through = {k: v for k, v in setups.items() if k in ("built", "byte_backpointers")}
    res = in_turns(latency, {k: (lambda a=a: call(a)) for k, a in shapes.items()
                             if k.startswith("latency")}, timer=cs.graph_ms)
    res_t = in_turns(through, {k: (lambda a=a: call(a)) for k, a in shapes.items()
                               if k == "throughput_B208_L678"}, timer=cs.graph_ms)
    res_c = in_turns(through, {k: (lambda a=a: call(a)) for k, a in shapes.items()
                               if k == "throughput_cells_mode"})
    _build._library = engine_lib
    print(json.dumps({"kernel": "viterbi", "card": smi,
                      "shapes": {k: [a[6], a[7]] for k, a in shapes.items()},
                      "plans": {k: a[8].__dict__ for k, a in shapes.items()},
                      "ms_latency": res,
                      "ms_throughput": {n: {**res_t[n], **res_c[n]} for n in res_t}}),
          flush=True)


def use_lib(lib):
    from infercnv_tpu_torch.ops import _build

    def setup():
        _build._library = lib
    return setup


SECTIONS = ("residual_fused", "smooth_general", "median", "median_plans",
            "smooth_banded", "viterbi")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: needs a CUDA card", file=sys.stderr)
        return 1
    wanted = set(sys.argv[1:]) or set(SECTIONS)
    if wanted - set(SECTIONS):
        print(f"torch_kernel_variants: sections are {SECTIONS}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from infercnv_tpu_torch.ops import _build, median
    from infercnv_tpu_torch.ops.layout import (
        coordinate_smoothing_operator, smoothing_operator)
    from infercnv_tpu_torch.ops.residual_fused import residual_fused
    from infercnv_tpu_torch.ops.smoothing import BandWeights, apply_banded_general
    from torch_breakdown import without_smooth

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    engine = _build.library()
    variants = {"residual_fused": ("residual_fused.cu", ["constant_bound_rows",
                                                        "select_vote"]),
                "smooth_general": ("smooth_general.cu", ["without_fmas"]),
                "median": ("median.cu", ["copy_only", "no_vote"]),
                "smooth_banded": ("smooth_banded.cu", ["one_block_a_row",
                                                       "loads_and_stores_only"]),
                "viterbi": ("viterbi.cu", sorted({v for s, v, _o, _n in EDITS
                                                  if s == "viterbi.cu"}))}
    libs = build_all([(src, v) for sec, (src, vs) in variants.items()
                      if sec in wanted for v in [None, *vs]])

    def setups(source: str) -> dict:
        return {v or "built": use_lib(lib) for (s, v), lib in libs.items()
                if s == source}

    if "smooth_banded" in wanted:
        smooth_banded_section(dev, smi, setups("smooth_banded.cu"))
    if "viterbi" in wanted:
        viterbi_section(dev, smi, setups("viterbi.cu"), engine)
    _build._library = engine
    if not wanted & {"residual_fused", "smooth_general", "median", "median_plans"}:
        print(smi, flush=True)
        return 0
    if "residual_fused" in wanted:
        inp = cs.make_inputs(dev)
        w, b, nf, noise, counts = (inp.engine.weights, inp.bounds, inp.nf,
                                   inp.noise, inp.counts_a)
        bare = without_smooth(w)
        res = in_turns(setups("residual_fused.cu"), {
            "median_with_denoised": lambda: residual_fused(counts, w, *b, nf,
                                                           noise_bounds=noise),
            "mean_without_smooth": lambda: residual_fused(counts, bare, *b, nf,
                                                          center_mean=True)})
        print(json.dumps({"kernel": "residual_fused", "card": smi,
                          "shape": list(counts.shape), "ms": res}), flush=True)
        del inp, bare
    if not wanted & {"smooth_general", "median", "median_plans"}:
        print(smi, flush=True)
        return 0

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    G = 8448
    cw = BandWeights.from_operator(coordinate_smoothing_operator(
        cs.human_like_genome(G), cs.COORD_WINDOW), dev)
    ww = BandWeights.from_operator(smoothing_operator(
        cs.human_like_genome(cs.WIDE_GENES), 101), dev)
    xc = torch.randn((cs.CHUNK, G), generator=gen, device=dev)
    xw = torch.randn((cs.WIDE_CHUNK, cs.WIDE_GENES), generator=gen, device=dev)
    if "smooth_general" in wanted:
        res = in_turns(setups("smooth_general.cu"), {
            "coordinates": lambda: apply_banded_general(xc, cw),
            "wide_genome": lambda: apply_banded_general(xw, ww)})
        print(json.dumps({"kernel": "smooth_general", "card": smi,
                          "shapes": {"coordinates": list(xc.shape),
                                     "wide_genome": list(xw.shape)}, "ms": res}),
              flush=True)

    # the median kernels on the two smooth outputs, with stage-2 bounds of
    # the reference's magnitude
    _build._library = engine
    yc, yw = apply_banded_general(xc, cw), apply_banded_general(xw, ww)
    del xc, xw
    bounds = {n: (-0.05 - 0.02 * torch.rand(n, generator=gen, device=dev),
                  0.05 + 0.02 * torch.rand(n, generator=gen, device=dev))
              for n in (G, cs.WIDE_GENES)}
    cases = {
        "row_median_coordinates": lambda: median.row_median(yc),
        "row_median_wide_genome": lambda: median.row_median(yw),
        "tail_wide_genome": lambda: median.median_center_residual(
            yw, *bounds[cs.WIDE_GENES], cs.WIDE_GENES),
        "tail_8448": lambda: median.median_center_residual(yc, *bounds[G], G)}
    if "median" in wanted:
        res = in_turns(setups("median.cu"), cases)
        print(json.dumps({"kernel": "median", "card": smi,
                          "shapes": {"coordinates": list(yc.shape),
                                     "wide_genome": list(yw.shape)}, "ms": res}),
              flush=True)
    if "median_plans" not in wanted:
        print(smi, flush=True)
        return 0

    # launch plans, with the kernels as built
    _build._library = engine
    planned = median.card_plan

    def plan_setup(**override):
        def setup():
            median.card_plan = (planned if not override else lambda g, ld, d:
                                median.median_plan(g, ld, *_build.card_limits(dev),
                                                   **override))
        return setup
    overrides = {"planned": {},
                 "threads256_blocks3": dict(threads=256, blocks_per_sm=3),
                 "threads512_blocks2": dict(threads=512, blocks_per_sm=2)}
    res = {"8448": in_turns({k: plan_setup(**v) for k, v in overrides.items()},
                            {"row_median": cases["row_median_coordinates"],
                             "tail": cases["tail_8448"]})}
    overrides = {"planned": {}, "threads512": dict(threads=512)}
    res["60000"] = in_turns({k: plan_setup(**v) for k, v in overrides.items()},
                            {"row_median": cases["row_median_wide_genome"],
                             "tail": cases["tail_wide_genome"]})
    median.card_plan = planned
    print(json.dumps({"kernel": "median_plans", "card": smi, "ms": res,
                      "plans": {k: median.card_plan(n, n, dev).__dict__
                                for k, n in (("8448", G),
                                             ("60000", cs.WIDE_GENES))}}),
          flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
