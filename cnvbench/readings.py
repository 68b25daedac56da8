"""Readings that the limits of a cell are set from (not a benchmark run).

    python cnvbench/readings.py --workload <name> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--fault-seeds 4 5 6 --faults altered_answer ...] \
        [--seconds 3] [--control-seconds 30]

In one process on the GPU: the numbers that the cell's job kind compares
(for the engine, cnvbench/check.py) for the program on each of --seeds,
for the kind's control (for the engine, the reference in TF32 in the
program's place, cnvbench/system.py ReferenceSystem) on each of
--control-seeds, and for each planted fault (cnvbench/faults.py) on each of
--fault-seeds, each after a window of --seconds (the control's of
--control-seconds, long enough for it to finish as many jobs as the check
compares) at the cell's own sizes.
One JSON line a reading; the limits in cnvbench/limits/ lie between the
program's largest readings and the control's smallest.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if __name__ == "__main__":
    sys.path[:] = [str(HERE.parent)] + [p for p in sys.path
                                         if Path(p or ".").resolve() != HERE]


def main(argv=None) -> int:
    from cnvbench import faults, run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=list(faults.FAULTS))
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = run.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    runs = ([("program", s, False) for s in args.seeds]
            + [("control", s, True) for s in args.control_seeds]
            + [(f, s, False) for f in args.faults for s in args.fault_seeds])
    for what, seed, control in runs:
        t = time.perf_counter()
        ctx = (faults.planted(what) if what in faults.FAULTS
               else contextlib.nullcontext())
        with ctx:
            out = run.run_cell(cell, seed, args.control_seconds if control
                               else args.seconds, False, dev,
                               control=control, t0=t)
        print(json.dumps({"workload": args.workload, "what": what, "seed": seed,
                          "jobs": out["jobs"], "correct": out["correct"],
                          "numbers": {k: v["value"] for k, v in out["checks"].items()},
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
