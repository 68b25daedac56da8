"""The port's entry points against the JAX package's: the CLI (`main` with
``--device cpu``) on the same comma- and tab-delimited files (exit codes,
file sets, the text outputs byte-equal and each PNG's block fingerprint
within 0.02, torch_port_util.assert_same_outputs), the top-level names of
the reference's NAMESPACE (tests/test_api_surface.py), CreateInfercnvObject
in both calling conventions, and data.synthetic_example.  The CLI runs the
i3 HMM, whose parameters draw nothing, so both packages' runs are held to
the same numbers; the numbers drawn from the residual (the heatmaps'
thresholds, its 1%/99% range) within 2e-5, as run()'s expr, as
tests/test_torch_pipeline.py holds them.  The median-filtered heatmap's
rows are compared as a set a group, and its image by size: the filter
makes neighbouring rows of a group (nearly) equal, so their clustering
order follows the residual's last bits (the filter itself is held exactly
to the reference on the same input in tests/test_torch_median_filter.py)."""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest

import infercnv_tpu
import infercnv_tpu_torch
from infercnv_tpu.cli import main as jax_main
from infercnv_tpu_torch import cli as tcli
from infercnv_tpu_torch.interop import infercnv_from_numpy

from test_cli_and_plots import _write_example_files
from torch_port_util import assert_same_outputs, one_thread_a_pool

ROOT = Path(__file__).resolve().parents[1]
NAMESPACE = ["run", "CreateInfercnvObject", "plot_cnv", "plot_per_group",
             "plot_subclusters", "sample_object", "add_to_seurat",
             "apply_median_filtering", "inferCNVBayesNet", "filterHighPNormals",
             "color_palette", "add_to_metadata", "InferCNV", "GeneOrder",
             "create_infercnv_object"]


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_a_pool():
        yield


def _args(files, out_dir, sep):
    counts, genes, ann = files
    return ["--raw_counts_matrix", str(counts), "--gene_order_file", str(genes),
            "--annotations_file", str(ann), "--ref_group_names", "normal",
            "--out_dir", str(out_dir), "--delim", sep, "--cutoff", "1",
            "--window_length", "21", "--HMM", "--HMM_type", "i3", "--denoise",
            "--median_filter", "--no_save_rds", "--BayesMaxPNormal", "0",
            "--png_res", "40"]


@pytest.mark.parametrize("sep,extra", [
    (",", ["--analysis_mode", "samples", "--title", "Custom Title",
           "--color_safe", "--ngchm"]),
    ("\t", ["--tumor_subcluster_partition_method", "qnorm", "--no_plot",
            "--HMM_report_by", "consensus"]),
])
def test_cli_matches_the_reference(tmp_path, sep, extra):
    files = _write_example_files(tmp_path, sep=sep)
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    assert jax_main(_args(files, dj, sep) + extra) == 0
    assert tcli.main(_args(files, dt, sep) + extra + ["--device", "cpu"]) == 0
    mf = "infercnv.median_filtered"
    names = assert_same_outputs(str(dt), str(dj), numeric=(
        ".heatmap_thresholds.txt",), tol=2e-5,
        skip=("step_timings.tsv", f"{mf}.observation_groupings.txt", f"{mf}.png"))
    if f"{mf}.png" in names:
        import matplotlib.image as mpimg

        assert mpimg.imread(dt / f"{mf}.png").shape == mpimg.imread(dj / f"{mf}.png").shape
        rows = [sorted((d / f"{mf}.observation_groupings.txt").read_text().splitlines())
                for d in (dt, dj)]
        assert rows[0] == rows[1]
    assert any(n.endswith("pred_cnv_regions.dat") for n in names)
    assert "map_metadata_from_infercnv.txt" in names
    if "--no_plot" not in extra:
        assert {"infercnv.observation_groupings.txt", "infercnv.heatmap_thresholds.txt",
                "infercnv.median_filtered.png"} <= set(names)


def test_cli_parser_has_every_reference_flag():
    from infercnv_tpu.cli import build_parser as jax_parser

    def flags(p):
        return {a.dest: (a.default, a.option_strings) for a in p._actions}

    t, j = flags(tcli.build_parser()), flags(jax_parser())
    assert t.pop("device") == (None, ["--device"])
    assert t == j


def test_cli_module_runs_as_a_script(tmp_path):
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-m", "infercnv_tpu_torch.cli", "--help"],
                         cwd=str(root), capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "--device" in res.stdout


def test_namespace_parity():
    for name in NAMESPACE:
        assert hasattr(infercnv_tpu_torch, name), name
        assert hasattr(infercnv_tpu, name), name
    # every name a JAX sub-package's __init__.py imports, the port's exports
    for sub in ("core", "io", "models", "report", "sim", "subcluster", "ops",
                "parallel", "runner", "viz"):
        tree = ast.parse((ROOT / "infercnv_tpu" / sub / "__init__.py").read_text())
        names = {a.asname or a.name for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) for a in node.names}
        tm = importlib.import_module(f"infercnv_tpu_torch.{sub}")
        assert names and not {n for n in names if not hasattr(tm, n)}, sub


def _same_object(t, j):
    np.testing.assert_array_equal(t.expr, j.expr)
    assert t.cell_names == j.cell_names
    assert t.gene_order.names == j.gene_order.names
    assert list(t.ref_groups) == list(j.ref_groups)
    assert list(t.obs_groups) == list(j.obs_groups)
    for a, b in ((t.ref_groups, j.ref_groups), (t.obs_groups, j.obs_groups)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_create_infercnv_object_both_conventions(tmp_path):
    files = [str(f) for f in _write_example_files(tmp_path, sep="\t")]
    kw = dict(raw_counts_matrix=files[0], gene_order_file=files[1],
              annotations_file=files[2], ref_group_names=["normal"])
    _same_object(infercnv_tpu_torch.CreateInfercnvObject(**kw),
                 infercnv_tpu.CreateInfercnvObject(**kw))
    _same_object(infercnv_tpu_torch.CreateInfercnvObject(*files, ["normal"]),
                 infercnv_tpu.CreateInfercnvObject(*files, ["normal"]))
    # the in-memory convention
    rng = np.random.default_rng(2)
    mem = dict(counts_matrix=rng.poisson(30, (60, 8)).astype(np.float64),
               gene_names=[f"g{i}" for i in range(60)],
               cell_names=[f"c{i}" for i in range(8)],
               annotations={f"c{i}": ("n" if i < 4 else "t") for i in range(8)},
               gene_order_table={f"g{i}": ("chr1", i * 100 + 1, i * 100 + 50)
                                 for i in range(60)},
               chr_file_order=["chr1"], ref_group_names=["n"], chr_exclude=())
    _same_object(infercnv_tpu_torch.CreateInfercnvObject(**mem),
                 infercnv_tpu.CreateInfercnvObject(**mem))
    with pytest.raises(TypeError, match="bogus"):
        infercnv_tpu_torch.CreateInfercnvObject(**kw, bogus=1)
    with pytest.raises(TypeError, match="multiple"):
        infercnv_tpu_torch.CreateInfercnvObject(files[0], raw_counts_matrix=files[0],
                                                gene_order_file=files[1],
                                                annotations_file=files[2])


def test_synthetic_example_equal():
    from infercnv_tpu import data as jdata
    from infercnv_tpu_torch import data as tdata

    _same_object(tdata.synthetic_example(seed=3), jdata.synthetic_example(seed=3))
    _same_object(tdata.synthetic_example(),
                 infercnv_from_numpy(vars(jdata.synthetic_example())))
    with pytest.raises(ValueError, match="n_chr"):
        tdata.synthetic_example(n_chr=2)
