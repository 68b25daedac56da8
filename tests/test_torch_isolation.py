"""The port stands alone: it imports neither JAX nor the JAX package, runs
on CUDA unless asked for the CPU, and builds nothing when imported."""

import ast
import importlib.util
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import infercnv_tpu_torch
from infercnv_tpu_torch.ops import _build
from infercnv_tpu_torch.ops import median as tmed
from infercnv_tpu_torch.ops import residual_fused as tres
from infercnv_tpu_torch.ops import smoothing as tsmooth
from infercnv_tpu_torch.ops import viterbi_kernel as tvit

from torch_port_util import gene_orders, hmms

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "infercnv_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "infercnv_tpu")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="infercnv_tpu_torch."))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "infercnv_tpu_torch.parallel.engine" in mods
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
            + "import importlib\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in mods)
            + "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        [*PKG.rglob("*.py"), ROOT / "chip_smoke.py",
                                         *(ROOT / "benchmarks").glob("torch_*.py")]))
def test_no_jax_imports(path):
    roots = set(_imported_roots(ROOT / path))
    assert not roots & set(FORBIDDEN), f"{path} imports {roots & set(FORBIDDEN)}"


def test_engine_defaults_to_cuda():
    _, tgo = gene_orders([40, 40])
    _, th = hmms()
    from infercnv_tpu_torch.parallel.engine import CnvEngine

    if torch.cuda.is_available():
        assert CnvEngine(tgo, th).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            CnvEngine(tgo, th)
        with pytest.raises(RuntimeError, match="CUDA"):
            infercnv_tpu_torch.resolve_device("cuda")
    assert CnvEngine(tgo, th, device="cpu").device.type == "cpu"


def test_cpu_wrappers_build_nothing():
    """CPU tensors take the plain versions: no library load, no launch."""
    _, tgo = gene_orders([60, 60])
    from infercnv_tpu_torch.ops.layout import smoothing_operator

    w = tsmooth.BandWeights.from_operator(smoothing_operator(tgo, 11), "cpu")
    wb = tsmooth.BandWeights.from_operator(smoothing_operator(tgo, 11), "cpu",
                                           bf16=True)
    x = torch.ones((3, 120))
    counters = [(m, name) for m in (tres, tsmooth, tvit, tmed)
                for name in dir(m) if name.startswith("LAUNCHES")]
    counts = {c: getattr(*c) for c in counters}
    tsmooth.apply_banded(x, w)
    tsmooth.apply_banded(x, wb)
    tsmooth.apply_banded_general(x, w)
    z = torch.zeros(120)
    tres.residual_fused(x, w, z, z, z, z, 100.0)
    tres.residual_fused(x, wb, z, z, z, z, 100.0)
    tmed.row_median(x)
    tmed.median_center_residual(x, z, z, 120)
    for S in (3, 6):
        tvit.viterbi(x, torch.full((3,), 120), torch.ones(3),
                     torch.zeros((3, 120), dtype=torch.int8),
                     np.arange(S) / 2.0, np.zeros(S), -1e-6, -13.8)
    assert len(counts) == 8
    assert {c: getattr(*c) for c in counters} == counts
    assert _build._library is None


def test_chip_smoke_imports_without_running(monkeypatch):
    def refuse():
        raise AssertionError("build() called while importing chip_smoke")

    monkeypatch.setattr(_build, "build", refuse)
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main)
    assert _build._library is None


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=str(ROOT), env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_sources_digest_covers_every_kernel_source():
    names = {p.name for p in _build.CSRC.glob("*.cu*")}
    assert {"residual_fused.cu", "smooth_banded.cu", "viterbi.cu",
            "band_smooth.cuh", "smooth_general.cu", "median.cu",
            "radix_select.cuh", "common.cu"} <= names
    assert len(_build.sources_digest()) == 64
