#!/usr/bin/env python3
"""What limits the fused residual and general smooth kernels, on one CUDA card.

    python3 benchmarks/torch_kernel_variants.py      (from the repository root)

Builds, beside the kernels as they are, copies of csrc/residual_fused.cu and
csrc/smooth_general.cu with one part taken out, loads each build and times
them in turns on chip_smoke.py's workloads (CUDA events, median of 5, in the
order built, variants, variants, built):

  residual_fused  as built; "constant_bound_rows": the four bound rows read
                  as constants (their loads from L2 gone).  Median with the
                  denoised output, and mean centring without the smooth.
  smooth_general  as built; "without_fmas": the tap loop skipped (staging,
                  barriers and stores remain).  Coordinates [32768, 8448]
                  and 60,000 genes [8192, 60000].

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
    ("smooth_general.cu", "without_fmas",
     "        if (es == c0 && ee == c0 + kWChunk) {",
     "        if (false) {"),
    ("smooth_general.cu", "without_fmas",
     "          for (int e = es; e < ee; e += 4) taps4(e);",
     "          for (int e = es; e < 0; e += 4) taps4(e);"),
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
    for name in ("ic_error_string", "ic_" + Path(source).stem):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _build._SIGNATURES[name]
    return lib


def in_turns(libs: dict, cases: dict) -> dict:
    """Each case timed with each library, built, variants, variants, built."""
    import chip_smoke as cs
    from infercnv_tpu_torch.ops import _build

    names = list(libs)
    out = {n: {c: [] for c in cases} for n in names}
    for name in names + names[::-1]:
        _build._library = libs[name]
        for c, fn in cases.items():
            out[name][c].append(cs.time_ms(fn))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from infercnv_tpu_torch.ops import _build
    from infercnv_tpu_torch.ops.layout import (
        coordinate_smoothing_operator, smoothing_operator)
    from infercnv_tpu_torch.ops.residual_fused import residual_fused
    from infercnv_tpu_torch.ops.smoothing import BandWeights, apply_banded_general
    from torch_breakdown import without_smooth

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    csrc = ROOT / "infercnv_tpu_torch" / "csrc"
    inp = cs.make_inputs(dev)
    engine = _build.library()
    w, b, nf, noise, counts = (inp.engine.weights, inp.bounds, inp.nf,
                               inp.noise, inp.counts_a)
    bare = without_smooth(w)
    libs = {v: build("residual_fused.cu", v, csrc)
            for v in (None, "constant_bound_rows")}
    res = in_turns({v or "built": lib for v, lib in libs.items()}, {
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
    libs = {v: build("smooth_general.cu", v, csrc) for v in (None, "without_fmas")}
    res = in_turns({v or "built": lib for v, lib in libs.items()}, {
        "coordinates": lambda: apply_banded_general(xc, cw),
        "wide_genome": lambda: apply_banded_general(xw, ww)})
    print(json.dumps({"kernel": "smooth_general", "card": smi,
                      "shapes": {"coordinates": list(xc.shape),
                                 "wide_genome": list(xw.shape)}, "ms": res}),
          flush=True)
    _build._library = engine
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
