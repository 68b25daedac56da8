#!/usr/bin/env python3
"""What limits the fused residual, general smooth and median kernels, on one
CUDA card.

    python3 benchmarks/torch_kernel_variants.py      (from the repository root)

Builds, beside the kernels as they are, copies of csrc/residual_fused.cu,
csrc/smooth_general.cu and csrc/median.cu with one part taken out (all
builds in parallel), loads each build and times them in turns on
chip_smoke.py's workloads (CUDA events, median of 5, in the order built,
variants, variants, built):

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


def in_turns(setups: dict, cases: dict) -> dict:
    """Each case timed under each setup (a function that installs a
    variant), first, others, others, first."""
    import chip_smoke as cs

    names = list(setups)
    out = {n: {c: [] for c in cases} for n in names}
    for name in names + names[::-1]:
        setups[name]()
        for c, fn in cases.items():
            out[name][c].append(cs.time_ms(fn))
    return out


def use_lib(lib):
    from infercnv_tpu_torch.ops import _build

    def setup():
        _build._library = lib
    return setup


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: needs a CUDA card", file=sys.stderr)
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
    libs = build_all([("residual_fused.cu", v) for v in
                      (None, "constant_bound_rows", "select_vote")]
                     + [("smooth_general.cu", v) for v in (None, "without_fmas")]
                     + [("median.cu", v) for v in (None, "copy_only", "no_vote")])

    def setups(source: str) -> dict:
        return {v or "built": use_lib(lib) for (s, v), lib in libs.items()
                if s == source}

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

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    G = 8448
    cw = BandWeights.from_operator(coordinate_smoothing_operator(
        cs.human_like_genome(G), cs.COORD_WINDOW), dev)
    ww = BandWeights.from_operator(smoothing_operator(
        cs.human_like_genome(cs.WIDE_GENES), 101), dev)
    xc = torch.randn((cs.CHUNK, G), generator=gen, device=dev)
    xw = torch.randn((cs.WIDE_CHUNK, cs.WIDE_GENES), generator=gen, device=dev)
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
    res = in_turns(setups("median.cu"), cases)
    print(json.dumps({"kernel": "median", "card": smi,
                      "shapes": {"coordinates": list(yc.shape),
                                 "wide_genome": list(yw.shape)}, "ms": res}),
          flush=True)

    # launch plans, with the kernels as built
    _build._library = engine
    planned = median.card_plan

    def plan_setup(**override):
        def setup():
            median.card_plan = (planned if not override else lambda g, ld, d:
                                median.median_plan(g, ld, *median._CARDS[0],
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
