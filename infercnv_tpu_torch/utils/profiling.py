"""Tracing of the port: per-step wall-clock timing of run(), and spans and
counters inside the engine's calls.

``StepTimer`` is copied from infercnv_tpu/utils/profiling.py (``_rss_gb``
and ``StepTimer``, lines 20-72) without its jax.profiler trace: every
pipeline step is timed and the table is written to ``step_timings.tsv`` in
the out_dir.  Each step's record and ``[timing]`` line also carry the
resident set at its end, split into anonymous memory and file pages
(``memory_gb``).  A step that computes on the card ends by copying its
result to the host, so its wall time includes the card's work.  Each step
is also a span, ``icnv.step.<name>``.

``span(name, device)`` and ``count(name, n)`` record only while a
torch.profiler records (``tracing()``); otherwise a span costs one
attribute check and a counter the same.  While on, a span records:

  * a host range in the profiler's trace (``_RecordFunctionFast``, the
    range ``torch.profiler.record_function`` builds without its user scope),
    so that its host interval lies on the clock of the device's line.  A
    user-scope range would also be drawn on the device's line as a
    ``gpu_user_annotation`` over the kernels it launched, which a reader of
    that line (torch 2.11's events carry no activity type) takes for device
    work;
  * on a CUDA device, a ``torch.cuda.Event`` pair on the current stream:
    the device time of the work the span enqueued.  The events are read
    only by ``span_totals()``; a span never synchronises;
  * its name, host start and end, its parent span and its root span (the
    outermost call the span serves: an engine call, or a step of run()).

The record stays in memory until ``reset_spans()``.  Span names begin with
``icnv.``; the counter ``host_syncs`` (``HOST_SYNCS``) counts the
operations in the engine's calls that make the host wait for the card: a
blocking copy of host data to it (``host_upload``) and a read of a device
value on the host (``host_read``, ``host_sync``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import resource
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

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


#: the counter of operations in the engine's calls that make the host wait
#: for the card
HOST_SYNCS = "host_syncs"

#: the record: every span recorded since the last reset_spans(), and the
#: counters' totals (module state: the profiler's switch is per process too)
_SPANS: List["SpanRecord"] = []
_COUNTS: Dict[str, int] = {}
_COUNT_LOCK = threading.Lock()
_IDS = itertools.count()
#: each thread's stack of open spans
_LOCAL = threading.local()
_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """Whether a torch.profiler is recording in this process: the switch of
    every span and counter (torch.autograd.profiler sets it as a profiler
    starts and clears it as it stops)."""
    return _autograd_profiler._is_profiler_enabled


@dataclasses.dataclass
class SpanRecord:
    """One span.  ``parent`` and ``root`` are ids of other records (``root``
    is the span's own id at the root); ``events`` is its (start, end) CUDA
    event pair on ``device``, None off CUDA; ``host_end_ns`` is 0 while the
    span is open."""

    id: int
    name: str
    parent: Optional[int]
    root: int
    host_start_ns: int
    host_end_ns: int = 0
    device: Optional[torch.device] = None
    events: Optional[list] = None

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) / 1e6

    def device_ms(self) -> float:
        """Milliseconds between the span's events on its stream (waits for
        the end event); 0.0 without events."""
        if self.events is None:
            return 0.0
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Span:
    """What span() returns while tracing: records on entry and on exit."""

    __slots__ = ("name", "device", "record", "_range", "_stream")

    def __init__(self, name: str, device):
        self.name = name
        self.device = None if device is None else torch.device(device)

    def __enter__(self) -> SpanRecord:
        stack = _stack()
        parent = stack[-1] if stack else None
        ident = next(_IDS)
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        rec = SpanRecord(ident, self.name, None if parent is None else parent.id,
                         ident if parent is None else parent.root,
                         time.perf_counter_ns(), device=self.device)
        if self.device is not None and self.device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
            rec.events = [start, None]
        stack.append(rec)
        _SPANS.append(rec)
        self.record = rec
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.record
        if rec.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            rec.events[1] = end
        rec.host_end_ns = time.perf_counter_ns()
        _stack().pop()
        self._range.__exit__(*exc)
        return False


def span(name: str, device=None):
    """A context manager around the work it encloses, recorded while a
    torch.profiler records (see the module's docstring) and otherwise a
    no-op; ``device``: where that work runs (CUDA events only there)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add n to a counter of the record, while a torch.profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        with _COUNT_LOCK:
            _COUNTS[name] = _COUNTS.get(name, 0) + n


def host_sync(device, n: int = 1) -> None:
    """Count n operations that make the host wait for ``device`` (a read of
    its values on the host, a blocking copy to it); only CUDA devices
    count."""
    if _autograd_profiler._is_profiler_enabled and torch.device(device).type == "cuda":
        count(HOST_SYNCS, n)


def host_upload(src, device, n: int = 1) -> None:
    """host_sync for n blocking copies of ``src`` to ``device``: a numpy
    array, a Python number or a host tensor (a tensor already on a CUDA
    device moves without the host)."""
    if _autograd_profiler._is_profiler_enabled and not (
            torch.is_tensor(src) and src.is_cuda):
        host_sync(device, n)


def host_read(value) -> None:
    """host_sync for reading ``value`` on the host (``.cpu()``, ``float()``,
    ``.item()``) when it is a tensor on a CUDA device."""
    if (_autograd_profiler._is_profiler_enabled and torch.is_tensor(value)
            and value.is_cuda):
        count(HOST_SYNCS)


def span_records() -> List[SpanRecord]:
    """The spans recorded since the last reset_spans(), in opening order."""
    return list(_SPANS)


def span_totals() -> Dict[str, Dict[str, float]]:
    """Per span name, over the closed spans of the record: ``count``,
    ``device_ms`` (between each span's events), ``self_device_ms`` (less
    what its child spans on the same device cover) and ``host_ms``.  Waits
    for the spans' events; call it after the work they enclose."""
    closed = [r for r in list(_SPANS) if r.host_end_ns]
    ms = {r.id: r.device_ms() for r in closed}
    by_id = {r.id: r for r in closed}
    covered: Dict[int, float] = defaultdict(float)
    for r in closed:
        parent = by_id.get(r.parent)
        if parent is not None and parent.device == r.device:
            covered[r.parent] += ms[r.id]
    out: Dict[str, Dict[str, float]] = {}
    for r in closed:
        t = out.setdefault(r.name, {"count": 0, "device_ms": 0.0,
                                    "self_device_ms": 0.0, "host_ms": 0.0})
        t["count"] += 1
        t["device_ms"] += ms[r.id]
        t["self_device_ms"] += ms[r.id] - covered[r.id] if r.events else 0.0
        t["host_ms"] += r.host_ms
    return out


def counter_totals() -> Dict[str, int]:
    """Each counter's total since the last reset_spans()."""
    with _COUNT_LOCK:
        return dict(_COUNTS)


def reset_spans() -> None:
    """Clear the record: spans and counters."""
    _SPANS.clear()
    with _COUNT_LOCK:
        _COUNTS.clear()


class StepTimer:
    def __init__(self, out_dir: Optional[str] = None):
        self.out_dir = out_dir
        self.records: List[Dict] = []

    @contextlib.contextmanager
    def step(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(f"icnv.step.{name}"):
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
