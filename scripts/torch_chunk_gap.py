#!/usr/bin/env python3
"""Host time between the main path's chunks, for one or more checkouts of
the port, on one CUDA card.

    python3 scripts/torch_chunk_gap.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a checkout (e.g. an unpacked `git archive` of
an earlier commit) whose infercnv_tpu_torch and chip_smoke.py are imported,
its kernels built in its own build/ directory.  Each runs in a process of
its own, in the order given, so that `parent change change parent`
compares two commits in turns in one call.  A process drives chip_smoke.py's
main path (make_inputs: bench.py's genome, u16 counts, 32,768-cell chunks,
16 subclusters), two warm-up chunks, then three times N_ITER
subcluster_chunk calls as drive() makes them, and reports for each:
the host-clock ms a chunk (ending in a synchronize), the chunks' mean
device span (CUDA events), the gap between them, the host ms to enqueue one
call, and how many times one call waited for the card
(torch.cuda.set_sync_debug_mode).  Prints one JSON line a checkout and the
card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path


def one(tree: Path) -> dict:
    import torch

    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from infercnv_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.library()
    inp = cs.make_inputs(dev)
    cs.warm_up(inp.engine, inp)
    rounds = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _resid, _acc, _states, spans = cs.drive(inp.engine, inp, cs.N_ITER)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / cs.N_ITER
        span = cs.span_ms(spans)
        rounds.append({"chunk_ms": wall, "span_ms": span, "gap_ms": wall - span})

    def call():
        return inp.engine.subcluster_chunk(inp.counts_a, inp.nf, inp.ml, inp.mr,
                                           inp.noise, inp.onehot)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    held = call()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    del held
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        held = call()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    waits = [str(w.message).splitlines()[0] for w in caught]
    return {"checkout": str(tree), "rounds": rounds, "enqueue_ms": enqueue_ms,
            "waits_in_one_call": len(waits), "waits": waits[:4]}


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_chunk_gap: needs a CUDA card", file=sys.stderr)
        return 1
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in sys.argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--one", tree],
                              capture_output=True, text=True, timeout=900)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            print(f"torch_chunk_gap: {tree} failed:\n{proc.stderr[-3000:]}",
                  file=sys.stderr)
            rc = 1
            continue
        print(lines[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
