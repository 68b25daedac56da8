#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one CUDA card.

    python3 benchmarks/torch_breakdown.py      (from the repository root)

Same workload as chip_smoke.py's main_path phase, from its make_inputs
(8448 genes, 32768-cell u16 chunks, 16 subclusters).  Prints JSON lines:
  residual   the fused residual kernel by variant: median vs mean centring
             (the difference is the radix select), with the denoised
             second output, and the smooth kernel alone over the same chunk
  chunk      the pieces of one subcluster_chunk: residual kernel, group-sum
             matmul, and (for comparison) denoise as separate PyTorch ops
  profile    torch.profiler over 2 subcluster_chunk calls: device time by
             kernel, and the device's idle share of the wall time
and the card's name and power limit (nvidia-smi).  Times are CUDA events,
median of 5 after a warm-up.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from infercnv_tpu_torch.ops.residual_fused import (
        counts_to_f32, denoise, residual_fused)
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
    print(json.dumps({"phase": "profile", "card": smi, "wall_ms": wall_ms,
                      "device_busy_ms": busy,
                      "idle_share": (1 - busy / wall_ms) if wall_ms else None,
                      "device_ms_by_kernel": top}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
