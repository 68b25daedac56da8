"""Per-step wall-clock timing of run().

Copied from infercnv_tpu/utils/profiling.py (``_rss_gb`` and ``StepTimer``,
lines 20-72) without its jax.profiler trace: every pipeline step is timed
and the table is written to ``step_timings.tsv`` in the out_dir.  A step
that computes on the card ends by copying its result to the host, so its
wall time includes the card's work.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

from infercnv_tpu_torch.utils.logging import log_info


def _rss_gb() -> float:
    """Current VmRSS in GB (0.0 off-Linux): per-step memory attribution."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


class StepTimer:
    def __init__(self, out_dir: Optional[str] = None):
        self.out_dir = out_dir
        self.records: List[Dict] = []

    @contextlib.contextmanager
    def step(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.records.append({"step": name, "seconds": round(dt, 4)})
            log_info(f"[timing] {name}: {dt:.3f}s (rss {_rss_gb():.1f} GB)")

    def finish(self) -> None:
        if self.out_dir:
            path = os.path.join(self.out_dir, "step_timings.tsv")
            with open(path, "w") as f:
                f.write("step\tseconds\n")
                for r in self.records:
                    f.write(f"{r['step']}\t{r['seconds']}\n")

    def as_json(self) -> str:
        return json.dumps(self.records)
