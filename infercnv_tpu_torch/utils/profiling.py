"""Per-step wall-clock timing of run().

Copied from infercnv_tpu/utils/profiling.py (``_rss_gb`` and ``StepTimer``,
lines 20-72) without its jax.profiler trace: every pipeline step is timed
and the table is written to ``step_timings.tsv`` in the out_dir.  Each
step's record and ``[timing]`` line also carry the resident set at its
end, split into anonymous memory and file pages (``memory_gb``).  A step
that computes on the card ends by copying its result to the host, so its
wall time includes the card's work.
"""

from __future__ import annotations

import contextlib
import json
import os
import resource
import time
from typing import Dict, List, Optional

from infercnv_tpu_torch.utils.logging import log_info


#: /proc/self/status fields of memory_gb, by the name they are returned under
_STATUS_FIELDS = {"VmRSS": "rss_gb", "RssAnon": "anon_gb", "RssFile": "file_gb"}


def memory_gb() -> Dict[str, float]:
    """The process's resident set in GB: all of it (VmRSS), its anonymous
    memory (RssAnon) and its file pages (RssFile: a disk memmap's touched
    pages), as far as /proc/self/status shows them (empty off-Linux), and
    its peak so far (getrusage's ru_maxrss, KiB)."""
    out: Dict[str, float] = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                key = line.split(":", 1)[0]
                if key in _STATUS_FIELDS:
                    out[_STATUS_FIELDS[key]] = int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    if out:
        out["peak_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    return out


def memory_text(mem: Optional[Dict[str, float]] = None) -> str:
    """'rss 12.3 GB (anon 10.1, file 2.2), peak 20.1' from memory_gb()."""
    mem = memory_gb() if mem is None else mem
    text = f"rss {mem.get('rss_gb', 0.0):.1f} GB"
    if "anon_gb" in mem:
        text += f" (anon {mem['anon_gb']:.1f}, file {mem.get('file_gb', 0.0):.1f})"
    if "peak_gb" in mem:
        text += f", peak {mem['peak_gb']:.1f}"
    return text


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
            mem = memory_gb()
            self.records.append({"step": name, "seconds": round(dt, 4),
                                 **{k: round(v, 3) for k, v in mem.items()}})
            log_info(f"[timing] {name}: {dt:.3f}s ({memory_text(mem)})")

    def finish(self) -> None:
        if self.out_dir:
            path = os.path.join(self.out_dir, "step_timings.tsv")
            with open(path, "w") as f:
                f.write("step\tseconds\n")
                for r in self.records:
                    f.write(f"{r['step']}\t{r['seconds']}\n")

    def as_json(self) -> str:
        return json.dumps(self.records)
