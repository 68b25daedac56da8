"""Job kinds (cnvbench/jobs/): a kind added as new files only runs through
the harness; a traffic file without ``"job"`` runs the engine kind, and an
unknown kind stops the run naming the file it looked for; the engine kind
keeps each cell's checks, metrics and result line."""

import filecmp
import json
import shutil
import subprocess
import sys

import pytest

from cnvbench import reference, run
from cnvbench.tests.cells import CELLS, small

#: a kind of its own: rows of a matrix drawn from the seed, a job their means
STUB_KIND = '''"""stub: a sample's rows drawn from the seed, a job their means."""
import numpy as np
import torch

SETUP_PARTS = ("draws", "systems")


class _System:
    def __init__(self, data, dtype):
        self.data, self.dtype = data, dtype

    def job(self, j, sample, keep, slot, spans):
        with spans("means"):
            means = self.data[sample].to(self.dtype).mean(dim=1).float().cpu()
        return None if slot is None else (sample, means)


class _Keep:
    def __init__(self, slots):
        self.slots = slots

    def offer(self, j):
        return j if j < self.slots else None


def draw(config, traffic, seed, device):
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    return torch.rand((traffic["samples"], traffic["rows"], config["width"]),
                      generator=gen, device=device)


def port(config, traffic, data, device):
    return _System(data, torch.float32)


def control(config, traffic, data, device):
    return _System(data, torch.bfloat16)


def keep(config, traffic, data, system, seed, device):
    return _Keep(int(traffic["check"]["jobs"]))


def facts(config, traffic, data, system, traced):
    return {"samples": data.shape[0], "cells_per_job": data.shape[1]}


def compare(config, traffic, data, results, device):
    err = 0.0
    for sample, means in results:
        want = data[sample].double().cpu().numpy().mean(axis=1)
        err = max(err, float(np.abs(means.numpy() - want).max()))
    return {"mean_err": err}
'''

STUB_FILES = {
    "jobs/stub.py": STUB_KIND,
    "configs/stub.json": json.dumps({"name": "stub", "width": 256, "reduced": []}),
    "traffic/stub_rows.json": json.dumps({"job": "stub", "samples": 3, "rows": 64,
                                          "warm_jobs": 1, "check": {"jobs": 2}}),
    "limits/stub_rows.stub.json": json.dumps({"mean_err": 1e-5}),
}
STUB_CONFIG = {"name": "stub", "source": "https://example.org/stub",
               "file": "cnvbench/configs/stub.json", "reduced": [],
               "why": "a job kind added as files only"}
STUB_CELL = {"name": "stub_rows.stub", "config": "stub", "traffic": "stub_rows",
             "chips": 1, "why": "the stub kind's rows, a job their means"}

#: run in the copy: its harness on the CPU, the port and then the control
DRIVE = """
import json, sys
from cnvbench import run
cell = run.load_cell("stub_rows.stub")
out = run.run_cell(cell, 2_150_000_101, 0.2, False, "cpu")
control = run.run_cell(cell, 2_150_000_102, 0.2, False, "cpu", control=True)
line = run.result_line(out, {"platform": "gpu", "kind": "cpu stand-in", "count": 1})
print(json.dumps({"harness": run.__file__, "line": line,
                  "setup_parts": sorted(out["setup_parts_s"]),
                  "control": control["correct"], "control_checks": control["checks"],
                  "imported": sorted({m.split(".")[0] for m in sys.modules}
                                     & {"jax", "infercnv_tpu", "infercnv_tpu_torch"})}))
"""


def _files(root):
    return {p.relative_to(root).as_posix() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_kind_added_as_new_files_only_runs(tmp_path):
    shutil.copytree(run.HERE, tmp_path / "cnvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    spec["configs"].append(STUB_CONFIG)
    spec["workloads"].append(STUB_CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    for name, text in STUB_FILES.items():
        (tmp_path / "cnvbench" / name).write_text(text)

    # the copy differs from the tree by the added files and entries alone
    tree, copy = _files(run.HERE), _files(tmp_path / "cnvbench")
    assert copy - tree == set(STUB_FILES) and tree <= copy
    _, mismatch, errors = filecmp.cmpfiles(run.HERE, tmp_path / "cnvbench",
                                           sorted(tree), shallow=False)
    assert mismatch == [] and errors == []
    spec_copy = run.load_json(tmp_path / "BENCHMARK.json")
    assert spec_copy["configs"].pop() == STUB_CONFIG
    assert spec_copy["workloads"].pop() == STUB_CELL
    assert spec_copy == run.load_json(run.ROOT / "BENCHMARK.json")

    proc = subprocess.run([sys.executable, "-c", DRIVE], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["harness"] == str(tmp_path / "cnvbench" / "run.py")
    line = got["line"]
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"cells_per_s", "job_p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) == {"mean_err"}
    assert got["setup_parts"] == ["draws", "systems", "warm_jobs"]
    # the kind's control in the port's place is refused
    assert got["control"] is False, got["control_checks"]
    assert got["imported"] == []


@pytest.mark.parametrize("traffic", ["cohort64k_sub", "cohort64k_cells"])
def test_traffic_without_job_is_the_engine(traffic):
    t = run.load_json(run.HERE / "traffic" / f"{traffic}.json")
    assert "job" not in t
    assert run.job_file(t) == run.HERE / "jobs" / "engine.py"
    kind = run.job_kind(t)
    for name in ("draw", "port", "control", "keep", "facts", "compare"):
        assert callable(getattr(kind, name))
    assert kind.SETUP_PARTS == ("cohort_draws", "samples_and_engines")


@pytest.mark.parametrize("job", ["nonesuch", "../engine", "", 3])
def test_unknown_kind_names_the_missing_file(job):
    with pytest.raises(SystemExit, match="looked for") as e:
        run.job_file({"job": job})
    assert f"{run.HERE / 'jobs'}" in str(e.value)
    cell = small(CELLS[0])
    cell["traffic"]["job"] = job
    with pytest.raises(SystemExit, match="looked for"):
        run.run_cell(cell, 1, 0.1, False, "cpu")


def test_engine_facts_are_the_readers_sizes():
    """The engine kind's facts: the cohort's and genome's sizes, and the
    smoothing operator's non-zeros in a traced run only."""
    cell = small("cohort64k_cells.coords_i3")
    config, traffic = cell["config"], cell["traffic"]
    kind = run.job_kind(traffic)
    data = kind.draw(config, traffic, 2_150_000_103, "cpu")
    system = kind.port(config, traffic, data, "cpu")
    plain = kind.facts(config, traffic, data, system, False)
    assert plain == {"samples": 2, "cells_per_job": 256, "ref_cells": 52, "genes": 512,
                     "chunks_per_job": 4, "hmm_states": 3, "band_nonzeros": 0}
    traced = kind.facts(config, traffic, data, system, True)
    assert traced["band_nonzeros"] == reference.band_nonzeros(
        data.genome, "coordinates", config["engine"]["window_length"]) > 0


CHECKS = {"cohort64k_sub.default_i6": {"resid_err", "mean_err", "state_gap"},
          "cohort64k_cells.default_i6": {"resid_err", "state_gap"},
          "cohort64k_cells.coords_i3": {"resid_err", "state_gap"}}


@pytest.mark.parametrize("name", CELLS)
def test_engine_cells_keep_their_checks_metrics_and_line(name):
    out = run.run_cell(small(name), 2_150_000_104, 0.2, False, "cpu")
    line = run.result_line(out, {"platform": "gpu", "kind": "x", "count": 1})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == CHECKS[name]
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    assert set(line["metrics"]) == {"cells_per_s", "job_p95_ms", "setup_s"}
    assert all(v["unit"] and v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["setup_parts_s"]) == {"cohort_draws", "samples_and_engines",
                                         "warm_jobs"}
    json.dumps(line, allow_nan=False)
