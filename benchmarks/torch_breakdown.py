#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one CUDA card.

    python3 benchmarks/torch_breakdown.py      (from the repository root)

Same workloads as chip_smoke.py's path phases, from its make_inputs.
Prints JSON lines:
  residual   main path (8448 genes, 32768-cell u16 chunks, 16 subclusters):
             the fused residual kernel by variant: median vs mean centring
             (the difference is the radix select), with the denoised
             second output, and the smooth kernel alone over the same chunk
  chunk      the pieces of one main-path subcluster_chunk: residual kernel,
             group-sum matmul, and (for comparison) denoise as separate
             PyTorch ops
  profile    torch.profiler over 2 main-path subcluster_chunk calls: device
             time by kernel, and the device's idle share of the wall time
  coords_chunk, coords_profile      the same split and profile for the
             coordinates path (wide-band route, 32768-cell chunks)
  wide_genome_chunk, wide_genome_profile   and for the 60,000-gene genome
             (wide-genome route, 8192-cell chunks)
and the card's name and power limit (nvidia-smi).  Times are CUDA events,
median of 5 after a warm-up.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def profile_chunks(engine, counts, nf, ml, mr, noise, onehot) -> dict:
    """torch.profiler over 2 subcluster_chunk calls: wall time, device busy
    time, the device's idle share, and the 8 kernels with the most device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine.subcluster_chunk(counts, nf, ml, mr, noise, onehot)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        acc = None
        for _ in range(2):
            _r, *acc = engine.subcluster_chunk(counts, nf, ml, mr, noise, onehot, acc=acc)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0)
        if dt and ev.key and not ev.key.startswith("aten::") and not ev.key.startswith("cuda"):
            by_kernel[ev.key[:90]] = dt / 1e3
    busy = sum(by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": (1 - busy / wall_ms) if wall_ms else None,
            "device_ms_by_kernel": top}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from infercnv_tpu_torch.ops.median import median_center_residual
    from infercnv_tpu_torch.ops.residual_fused import (
        counts_to_f32, denoise, residual_fused, where_bounds)
    from infercnv_tpu_torch.ops.smoothing import apply_banded

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    inp = cs.make_inputs(dev)
    engine, counts, nf, onehot = inp.engine, inp.counts_a, inp.nf, inp.onehot
    ml, mr, noise, b = inp.ml, inp.mr, inp.noise, inp.bounds
    w = engine.weights
    t = cs.time_ms

    res = {"median": t(lambda: residual_fused(counts, w, *b, nf))}
    res["mean"] = t(lambda: residual_fused(counts, w, *b, nf, center_mean=True))
    res["median_with_denoised"] = t(lambda: residual_fused(counts, w, *b, nf,
                                                           noise_bounds=noise))
    x = counts_to_f32(counts)
    res["smooth_kernel_alone"] = t(lambda: apply_banded(x, w))
    res["copy_1_1GB"] = t(lambda: x.clone())
    del x
    print(json.dumps({"phase": "residual", "card": smi, "chunk": cs.CHUNK, **res}), flush=True)

    resid = residual_fused(counts, w, *b, nf)
    chunk = {
        "residual_kernel": res["median_with_denoised"],
        "group_sums_matmul": t(lambda: onehot @ resid),
        "denoise_alone": t(lambda: denoise(resid, noise)),
        "bounds_rows": t(lambda: [ml.amin(0), ml.amax(0), mr.amin(0), mr.amax(0)]),
        "subcluster_chunk": t(lambda: engine.subcluster_chunk(counts, nf, ml, mr, noise, onehot)),
    }
    print(json.dumps({"phase": "chunk", "card": smi, **chunk}), flush=True)
    del resid

    print(json.dumps({"phase": "profile", "card": smi,
                      **profile_chunks(engine, counts, nf, ml, mr, noise, onehot)}),
          flush=True)

    # the unfused routes: coordinates (wide band) and 60,000 genes
    for name, ui in (
            ("coords", cs.make_inputs(dev, go=cs.human_like_genome(inp.go.num_genes),
                                      smooth_method="coordinates",
                                      window_length=cs.COORD_WINDOW)),
            ("wide_genome", cs.make_inputs(dev, go=cs.human_like_genome(cs.WIDE_GENES),
                                           chunk=cs.WIDE_CHUNK))):
        e = ui.engine
        c, nf_t = ui.counts_a, e._f32(ui.nf)
        b2 = [ui.mr.amin(0).contiguous(), ui.mr.amax(0).contiguous()]
        x = e._clipped_x(c, nf_t, ui.ml)
        y = e._smooth(x)
        pieces = {"route": e.residual_route,
                  "normalise_log_bounds_clip": t(lambda: e._clipped_x(c, nf_t, ui.ml)),
                  "smooth_general": t(lambda: e._smooth(x))}
        if e.residual_route == "wide_genome":
            pieces["median_center_residual"] = t(
                lambda: median_center_residual(y, *b2, y.shape[1]))
            r = median_center_residual(y, *b2, y.shape[1])
        else:
            pieces["centre_row_median_and_subtract"] = t(lambda: e._centre(y))
            yc = e._centre(y)
            pieces["bounds_exp2"] = t(lambda: torch.exp2(where_bounds(yc, *b2)))
            r = torch.exp2(where_bounds(yc, *b2))
        del x, y
        pieces["denoise"] = t(lambda: denoise(r, ui.noise))
        pieces["group_sums_matmul"] = t(lambda: ui.onehot @ r)
        del r
        pieces["subcluster_chunk"] = t(lambda: e.subcluster_chunk(
            c, ui.nf, ui.ml, ui.mr, ui.noise, ui.onehot))
        print(json.dumps({"phase": f"{name}_chunk", "card": smi,
                          "shape": list(c.shape), **pieces}), flush=True)
        print(json.dumps({"phase": f"{name}_profile", "card": smi,
                          **profile_chunks(e, c, ui.nf, ui.ml, ui.mr,
                                           ui.noise, ui.onehot)}), flush=True)
        del ui, e, c
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
