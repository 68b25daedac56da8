"""One run of one cell of the benchmark.

    python cnvbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from BENCHMARK.json at the checkout's root, its
configuration (cnvbench/configs/<config>.json), its traffic mix
(cnvbench/traffic/<traffic>.json), its job kind (cnvbench/jobs/<kind>.py,
named by the traffic's ``"job"``, "engine" where it names none) and its
limits (cnvbench/limits/<workload>.json); each metric is computed by its
reader, cnvbench/metrics/<metric>.py.  Set-up draws the kind's data on the
GPU from the seed, builds the program's system and runs warm jobs of the
cell's own shapes; the window runs jobs back to back for ``--seconds`` (the
job under way when the time runs out is finished and counted); with
``--trace 1`` the window is traced by torch.profiler and the per-layer
metrics are reported instead of the end-to-end ones.  After the window the
program's state is freed and the kind compares a sample of the jobs with
its plain reference.  The last line of standard output is one JSON object:
correct, attempted, failed, metrics, device[, breakdown], checks.

Exits non-zero, printing no result, without a CUDA device (there is no CPU
fallback) and if jax, jaxlib, flax or infercnv_tpu was imported.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if __name__ == "__main__":
    # import the harness as a package from the checkout's root, and never its
    # modules by their bare names (trace.py would shadow the standard library's)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != HERE]

#: top-level modules that no process of the benchmark may import
FORBIDDEN = ("jax", "jaxlib", "flax", "infercnv_tpu")
#: build and kernel caches, at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda_jit"}
#: the job kind of a traffic file that names none
DEFAULT_JOB = "engine"
_KIND = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_\-]{0,63}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The workload entry of BENCHMARK.json with its configuration, traffic,
    limits and the metrics it reports."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"cnvbench: no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    config_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    job_file(traffic)
    return {"workload": w, "spec": spec,
            "config": load_json(root / config_entry["file"]),
            "traffic": traffic,
            "limits": load_json(HERE / "limits" / f"{name}.json")}


def job_file(traffic: dict) -> Path:
    """The file of the traffic's job kind; stops the run where there is none."""
    kind = traffic.get("job", DEFAULT_JOB)
    path = HERE / "jobs" / f"{kind}.py"
    if not (isinstance(kind, str) and _KIND.match(kind) and path.is_file()):
        raise SystemExit(f"cnvbench: unknown job kind {kind!r}: looked for {path}")
    return path


def job_kind(traffic: dict) -> types.ModuleType:
    """The traffic's job kind (cnvbench/jobs/__init__.py says what it gives)."""
    path = job_file(traffic)
    name = f"cnvbench.jobs.{path.stem}"
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = mod       # where dataclasses look up its annotations
    mod_spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, name: str, kind: str) -> list:
    """The metrics of a kind ("end_to_end" or "per_layer") that cell reports:
    those listing it, and those without a list (an end-to-end one in every
    cell; a per-layer one in every cell reporting what it moves)."""
    e2e = [m["name"] for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    out = []
    for m in spec[kind]:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"cnvbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def launch_counts() -> dict:
    """The program's launch counters (each ``LAUNCHES*`` integer of its ops
    modules), by module and name."""
    out = {}
    for mod_name, mod in list(sys.modules.items()):
        if mod_name.startswith("infercnv_tpu_torch.ops.") and mod is not None:
            for k, v in vars(mod).items():
                if k.startswith("LAUNCHES") and isinstance(v, int):
                    out[f"{mod_name.rsplit('.', 1)[1]}.{k}"] = v
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             control: bool = False, t0: float = None) -> dict:
    """Set-up, window and comparison of one cell; returns what the result
    line is made of (no printing).  The cell's job kind gives the data, the
    system (its control in the port's place where ``control``), the jobs
    kept for the check, the facts the readers take and the comparison."""
    import numpy as np
    import torch

    from cnvbench import check
    from cnvbench import trace as tracing

    t0 = T0 if t0 is None else t0
    device = torch.device(device)
    cuda = device.type == "cuda"
    config, traffic = cell["config"], cell["traffic"]
    job = job_kind(traffic)
    parts = {}

    def part(name, since):
        if cuda:
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        parts[name] = now - since
        return now

    t = time.perf_counter()
    data = job.draw(config, traffic, seed, device)
    t = part(job.SETUP_PARTS[0], t)
    system = (job.control if control else job.port)(config, traffic, data, device)
    keep = job.keep(config, traffic, data, system, seed, device)
    facts = job.facts(config, traffic, data, system, trace)
    t = part(job.SETUP_PARTS[1], t)
    samples = int(facts["samples"])
    off = tracing.Spans(False)
    for j in range(int(traffic["warm_jobs"])):
        # the first warm job also keeps what the check compares, as the
        # window's sampled jobs do, so that no kernel loads in the window
        system.job(j, j % samples, keep, 0 if j == 0 else None, off)
    part("warm_jobs", t)
    before = launch_counts()
    setup_s = time.perf_counter() - t0

    spans = tracing.Spans(trace)
    prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                               torch.profiler.ProfilerActivity.CUDA])
            if trace else None)
    results, job_s = {}, []
    if prof is not None:
        prof.__enter__()
    try:
        label = (torch.profiler.record_function(tracing.WINDOW_LABEL) if trace
                 else None)
        if label is not None:
            label.__enter__()
        t_start = time.perf_counter()
        j = 0
        while time.perf_counter() - t_start < seconds or j == 0:
            slot = keep.offer(j)
            a = time.perf_counter()
            r = system.job(j, j % samples, keep, slot, spans)
            job_s.append(time.perf_counter() - a)
            if slot is not None:
                results[slot] = r
            j += 1
        t_end = time.perf_counter()
        if label is not None:
            label.__exit__(None, None, None)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    if cuda:
        torch.cuda.synchronize(device)
    after = launch_counts()
    jobs = len(job_s)
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    ctx = types.SimpleNamespace(
        setup_s=setup_s, window_s=t_end - t_start, job_seconds=job_s, jobs=jobs,
        cells_done=jobs * facts["cells_per_job"], spans=spans,
        trace=None, library=set(), notes={}, **facts)
    out = {"jobs": jobs, "setup_s": setup_s, "setup_parts_s": parts,
           "window_s": ctx.window_s, "memory_peak_bytes": memory_peak,
           "launches_per_job": {k: (after[k] - before.get(k, 0)) / jobs for k in after}}
    if trace:
        import infercnv_tpu_torch

        ctx.trace = tracing.read(prof)
        ctx.library = tracing.library_kernels(Path(infercnv_tpu_torch.__file__).parent)
        del prof
        if ctx.trace is not None:
            out["busy_s"] = ctx.trace.busy_s
            out["trace_window_s"] = ctx.trace.window_s
            out["breakdown"] = {"device_ops": tracing.top(ctx.trace.op_seconds()),
                                "idle_gaps": tracing.top(ctx.trace.idle_gaps())}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(cell["spec"], cell["workload"]["name"], kind):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out["metrics"] = metrics
    out["roofline_notes"] = ctx.notes
    p95 = float(np.percentile(job_s, 95))
    out["beyond_p95"] = sum(1 for s in job_s if s > p95)
    out["job_ms_quantiles"] = {q: float(np.percentile(job_s, q)) * 1e3
                               for q in (0, 10, 50, 90, 95, 99, 100)}

    # the comparison, once the program's state is freed
    del system
    if cuda:
        torch.cuda.empty_cache()
    numbers = job.compare(config, traffic, data,
                           [results[k] for k in sorted(results)], device)
    out["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                         "limit": cell["limits"].get(k)}
                     for k, v in numbers.items()}
    out["correct"] = check.verdict(numbers, cell["limits"])
    return out


def result_line(out: dict, device: dict) -> dict:
    """The last line of a run: correct, attempted, failed, metrics, device
    (with the peak memory and, traced, the busy seconds and the window),
    breakdown where traced, and the numbers compared with their limits."""
    device = dict(device, memory_peak_bytes=out["memory_peak_bytes"])
    if "busy_s" in out:
        device.update(busy_s=out["busy_s"], window_s=out["trace_window_s"])
    result = {"correct": out["correct"], "attempted": out["jobs"], "failed": 0,
              "metrics": out["metrics"], "device": device}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "cnvbench" / sub)
    cell = load_cell(args.workload)

    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cnvbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"cnvbench: the run imported {', '.join(found)}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips}
    if args.trace and "busy_s" not in out:
        print("cnvbench: the profiler recorded no window", file=sys.stderr)
        return 5
    print(json.dumps({"cell": args.workload, "seed": args.seed, "card": smi,
                      "jobs": out["jobs"], "beyond_p95": out["beyond_p95"],
                      "job_ms_quantiles": out["job_ms_quantiles"],
                      "window_s": out["window_s"], "setup_s": out["setup_s"],
                      "setup_parts_s": out["setup_parts_s"],
                      "launches_per_job": out["launches_per_job"],
                      "roofline": out["roofline_notes"]}), flush=True)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result_line(out, device), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
