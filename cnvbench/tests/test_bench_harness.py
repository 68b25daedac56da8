"""The harness: BENCHMARK.json against the benchmark's contract, discovery
of each cell's files, the result line, the isolation from JAX, the reading of
a trace and the counting functions."""

import json
import re
import subprocess
import sys
import types

import pytest

from cnvbench import reference, roofline, run, trace
from cnvbench.genomes import make_genome
from cnvbench.tests.cells import CELLS, small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = run.load_json(run.ROOT / "BENCHMARK.json")


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["cnvbench"] and SPEC["command"][1] == "cnvbench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cnvbench/") and (run.ROOT / c["file"]).exists()
        assert c["reduced"] == run.load_json(run.ROOT / c["file"])["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for entry in SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(entry["name"]) and entry["name"] not in names
        names.add(entry["name"])
        if "unit" in entry:
            assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_and_metrics_are_found(name):
    cell = run.load_cell(name)
    assert set(cell["limits"]) >= {"resid_err", "state_gap"}
    e2e = [m["name"] for m in run.cell_metrics(SPEC, name, "end_to_end")]
    layer = [m["name"] for m in run.cell_metrics(SPEC, name, "per_layer")]
    assert e2e == ["cells_per_s", "job_p95_ms", "setup_s"]
    assert {"device_idle_pct", "chunk_ms", "per_job_ms", "torch_ops_ms"} <= set(layer)
    assert any(k.startswith("roofline_pct.") for k in layer)
    for m in e2e + layer:
        assert callable(run.reader(m))


def test_result_line_from_a_small_run():
    out = run.run_cell(small(CELLS[0]), 2_150_000_006, 0.2, False, "cpu")
    line = run.result_line(out, {"platform": "gpu", "kind": "x", "count": 1})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["attempted"] == out["jobs"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"cells_per_s", "job_p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) == {"resid_err", "mean_err", "state_gap"}
    json.dumps(line, allow_nan=False)


def test_no_gpu_no_result(tmp_path):
    proc = subprocess.run([sys.executable, str(run.HERE / "run.py"), "--workload",
                           CELLS[0], "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout == ""


def test_reference_and_generators_import_nothing_of_the_program():
    code = ("import sys; import cnvbench.reference, cnvbench.genomes, cnvbench.cohort, "
            "cnvbench.roofline, cnvbench.check, cnvbench.trace; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'infercnv_tpu', 'infercnv_tpu_torch'}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=run.ROOT, timeout=300, check=True)
    assert proc.stdout.strip() == "[]"
    for f in ("reference.py", "genomes.py", "cohort.py", "roofline.py", "check.py"):
        assert "infercnv" not in "".join(
            ln for ln in (run.HERE / f).read_text().splitlines(True)
            if ln.lstrip().startswith(("import ", "from ")))


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "infercnv_tpu_torch_fake", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["jax"]


def test_kernel1_bytes_and_least_time():
    """[32768, 8448] u16 with the denoised output: 553,648,128 bytes of
    counts read, 2 x 1,107,296,256 written; 0.826 ms at 3.35 TB/s."""
    g = make_genome({"kind": "bench", "genes": 8448})
    nnz = reference.band_nonzeros(g, "pyramidinal", 101)
    nbytes, flops = roofline.residual_fused(32768, 8448, nnz)
    small_inputs = nnz * 4 + 4 * 8448 * 4
    assert nbytes - small_inputs == 553_648_128 + 2 * 1_107_296_256
    least, by = roofline.least_seconds(nbytes, flops)
    assert by == "bytes" and 0.826e-3 <= least < 0.828e-3


def test_trace_window_busy_idle_and_names():
    ms = 1_000_000
    dev = [("void icnv::residual_fused_kernel<unsigned short, float, false>(A, float*)",
            "kernel", 1 * ms, 4 * ms),
           ("void at::native::elementwise_kernel<128, 2>(int)", "kernel", 3 * ms, 5 * ms),
           ("Memcpy DtoH (Device -> Pinned)", "memcpy", 7 * ms, 8 * ms)]
    host = [("cnvbench.window", 0, 10 * ms), ("cnvbench.chunk", 0, 6 * ms),
            ("aten::index", 5 * ms + 10, 6 * ms - 10),
            ("cnvbench.viterbi", 6 * ms, 9 * ms), ("cudaStreamSynchronize", 8 * ms, 9 * ms)]
    w = trace.Window(dev, host, (0, 10 * ms))
    assert w.busy_s == pytest.approx(5e-3) and w.window_s == pytest.approx(1e-2)
    assert w.kernel_seconds() == pytest.approx({"residual_fused_kernel": 3e-3,
                                                "elementwise_kernel": 2e-3})
    gaps = w.idle_gaps()
    assert gaps == pytest.approx({"chunk/python": 1e-3, "chunk/aten::index": 1e-3,
                                  "viterbi/python": 1e-3, "viterbi/cudaStreamSynchronize": 1e-3,
                                  "between jobs/python": 1e-3}) or sum(gaps.values()) == \
        pytest.approx(5e-3)
    assert sum(gaps.values()) == pytest.approx(5e-3)
    ctx = types.SimpleNamespace(trace=w, jobs=2, chunks_per_job=1, notes={},
                                library={"residual_fused_kernel"}, cells_per_job=32768,
                                genes=8448, band_nonzeros=10, ref_cells=0,
                                spans=types.SimpleNamespace(ms=lambda k: [2.0, 4.0]
                                                            if k == "chunk" else []))
    assert run.reader("device_idle_pct")(ctx) == pytest.approx(50.0)
    assert run.reader("torch_ops_ms")(ctx) == pytest.approx(1.0)
    assert run.reader("chunk_ms")(ctx) == pytest.approx(3.0)
    assert run.reader("per_job_ms")(ctx) is None
    assert run.reader("roofline_pct.row_median")(ctx) is None
    assert run.reader("roofline_pct.residual_fused")(ctx) > 0


def test_library_kernels_are_read_from_the_sources():
    import infercnv_tpu_torch
    from pathlib import Path

    names = trace.library_kernels(Path(infercnv_tpu_torch.__file__).parent)
    assert {"residual_fused_kernel", "viterbi_batch_kernel", "viterbi_latency_kernel",
            "smooth_general_kernel", "smooth_banded_kernel", "median_rows_kernel"} <= names
