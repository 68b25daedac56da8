"""The traced window: torch.profiler over the window, read into what the
per-layer metrics and the result's ``breakdown`` need.

Device operations are the profiler's CUDA events (kernels, copies, sets);
the window is the ``cnvbench.window`` annotation around the measured jobs.
Busy time is the union of the device operations' intervals inside it.  An
idle gap of the device is named by what the host was doing at its middle:
the innermost ``cnvbench.*`` span and the innermost host operation.
``Spans`` puts those spans, with a CUDA event pair each, around a job's
calls.
"""

from __future__ import annotations

import contextlib
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

WINDOW_LABEL = "cnvbench.window"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s+)?(\w+)\s*\(")


def kernel_base(name: str) -> str:
    """A kernel's name without its return type, namespaces' arguments,
    template arguments and parameters: ``void f<int>(A)`` -> ``f``."""
    n = name[5:] if name.startswith("void ") else name
    for stop in ("<", "("):
        i = n.find(stop)
        if i > 0:
            n = n[:i]
    return n.strip()


def short_name(name: str) -> str:
    """A kernel's base name without its namespaces: ``icnv::f`` -> ``f``."""
    return kernel_base(name).rsplit("::", 1)[-1]


def library_kernels(package_dir: Path) -> set:
    """Names of the kernels the program builds from its own CUDA sources."""
    names = set()
    for src in sorted((package_dir / "csrc").glob("*.cu*")):
        names.update(_GLOBAL.findall(src.read_text()))
    return names


class Window:
    """Device and host events of a traced window."""

    def __init__(self, device_events, host_events, window: Tuple[int, int]):
        #: (name, kind, start_ns, end_ns) of each device operation in the window
        self.device = [e for e in device_events if e[3] > window[0] and e[2] < window[1]]
        self.host = host_events
        self.window = window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        t0, t1 = self.window
        ivs = sorted((max(s, t0), min(e, t1)) for _n, _k, s, e in self.device)
        merged: List[List[int]] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_seconds(self) -> Dict[str, float]:
        """Device seconds of each kernel, by base name without namespaces."""
        out: Dict[str, float] = defaultdict(float)
        for name, kind, s, e in self.device:
            if kind == "kernel":
                out[short_name(name)] += (e - s) * 1e-9
        return dict(out)

    def op_seconds(self) -> Dict[str, float]:
        """Device seconds of every operation (kernels by base name)."""
        out: Dict[str, float] = defaultdict(float)
        for name, kind, s, e in self.device:
            out[kernel_base(name) if kind == "kernel" else name] += (e - s) * 1e-9
        return dict(out)

    def idle_gaps(self) -> Dict[str, float]:
        """Idle seconds of the device, by what the host was doing: one sweep
        over the host events (one thread, so properly nested) keeps the
        stack of those enclosing each gap's middle."""
        busy = self.busy_intervals()
        t0, t1 = self.window
        edges = [t0] + [x for iv in busy for x in iv] + [t1]
        out: Dict[str, float] = defaultdict(float)
        stack: List[Tuple[str, int]] = []
        i = 0
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            while i < len(self.host) and self.host[i][1] <= mid:
                name, s, e = self.host[i]
                while stack and stack[-1][1] < s:
                    stack.pop()
                stack.append((name, e))
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            live = [n for n, e in stack if e >= mid]
            spans = [n[len("cnvbench."):] for n in live
                     if n.startswith("cnvbench.") and n != WINDOW_LABEL]
            ops = [n for n in live if not n.startswith("cnvbench.")]
            out[f"{spans[-1] if spans else 'between jobs'}/"
                f"{ops[-1] if ops else 'python'}"] += (b - a) * 1e-9
        return dict(out)


def top(d: Dict[str, float], n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def read(prof) -> Optional[Window]:
    """The window of a finished torch.profiler.profile, or None when the
    profiler recorded no window."""
    events = prof.profiler.kineto_results.events()
    device, host = [], []
    window = None
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            at = getattr(ev, "activity_type", "")
            kind = str((at() if callable(at) else at) or "").lower()
            name = ev.name()
            if "annotation" in kind or name.startswith("cnvbench."):
                continue          # the harness's spans drawn on the device's line
            if "memcpy" in kind or name.startswith("Memcpy"):
                kind = "memcpy"
            elif "memset" in kind or name.startswith("Memset"):
                kind = "memset"
            else:
                kind = "kernel"
            device.append((name, kind, s, e))
        else:
            if ev.name() == WINDOW_LABEL:
                window, thread = (s, e), ev.start_thread_id()
            host.append((ev.name(), s, e, ev.start_thread_id()))
    if window is None:
        return None
    # the host thread that ran the window
    host = sorted(((n, s, e) for n, s, e, th in host if th == thread),
                  key=lambda h: h[1])
    return Window(device, host, window)


class Spans:
    """CUDA-event pairs and profiler labels around the program's calls; off
    outside a traced run, where it does nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.pairs = {}

    @contextlib.contextmanager
    def __call__(self, kind: str):
        if not self.on:
            yield
            return
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function(f"cnvbench.{kind}"):
            a.record()
            yield
            b.record()
        self.pairs.setdefault(kind, []).append((a, b))

    def ms(self, kind: str) -> list:
        """Device milliseconds of each span of a kind (after a synchronise)."""
        return [a.elapsed_time(b) for a, b in self.pairs.get(kind, [])]
