"""The port's per-group plots and Seurat export (device="cpu") against the
JAX package's: sample_object picks the same cells (the same numpy
Generator draws) in each mode, plot_per_group writes the same files, and
compute_cnv_features, the file-mode load_group_regions_from_out_dir and
add_to_seurat equal the JAX package's on out-dirs that the two packages'
run() wrote from one object (as tests/test_seurat_file_mode.py reads a
finished run)."""

import os

import numpy as np
import pytest

import infercnv_tpu.report.seurat_export as jse
import infercnv_tpu.viz.per_group as jpg
import infercnv_tpu_torch.report.seurat_export as tse
import infercnv_tpu_torch.viz.per_group as tpg
from infercnv_tpu_torch.interop import infercnv_from_numpy

from test_torch_heatmap import _objects
from test_torch_pipeline import BAYES_MODES, _pair, carried, standin  # noqa: F401
from torch_port_util import assert_same_outputs, one_thread_a_pool


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_a_pool():
        yield


def _sampling_object():
    """make_synthetic's object with a stored tumour dendrogram and
    subclusters: 30 normal, 30 tumour cells."""
    from scipy.cluster import hierarchy

    jo, _ = _objects()
    t = np.asarray(jo.obs_groups["tumor"])
    jo.tumor_subclusters["hc"] = {"tumor": hierarchy.linkage(jo.expr[t], "ward")}
    return jo, infercnv_from_numpy(vars(jo))


SAMPLING = {
    "down_by_subcluster": dict(n_cells=10),
    "down_plain": dict(n_cells=2),
    "up": dict(n_cells=45),
    "every_n": dict(n_cells=None, every_n=4, above_m=20),
    "observations_only": dict(n_cells=7, on_references=False),
}


@pytest.mark.parametrize("mode", list(SAMPLING))
def test_sample_object_picks_the_same_cells(mode):
    jo, to = _sampling_object()
    sj = jpg.sample_object(jo, seed=11, **SAMPLING[mode])
    st = tpg.sample_object(to, seed=11, **SAMPLING[mode])
    assert st.cell_names == sj.cell_names
    np.testing.assert_array_equal(st.expr, sj.expr)
    for a, b in ((st.ref_groups, sj.ref_groups), (st.obs_groups, sj.obs_groups)):
        assert list(a) == list(b)
        for g in b:
            np.testing.assert_array_equal(a[g], b[g])
    subs_t, subs_j = st.tumor_subclusters["subclusters"], sj.tumor_subclusters["subclusters"]
    assert {g: {k: list(v) for k, v in s.items()} for g, s in subs_t.items()} == \
        {g: {k: list(v) for k, v in s.items()} for g, s in subs_j.items()}
    assert list(st.tumor_subclusters["hc"]) == list(sj.tumor_subclusters["hc"])


def test_plot_per_group_writes_the_same_files(tmp_path):
    jo, to = _sampling_object()
    kw = dict(png_res=40, sample=True, n_cells=12, above_m=20, write_expr_matrix=True)
    pj = jpg.plot_per_group(jo, str(tmp_path / "jax"), **kw)
    pt = tpg.plot_per_group(to, str(tmp_path / "torch"), device="cpu", **kw)
    assert [os.path.basename(p) for p in pt] == [os.path.basename(p) for p in pj]
    names = assert_same_outputs(str(tmp_path / "torch"), str(tmp_path / "jax"))
    assert {"infercnv_per_group_REF_normal.png", "infercnv_per_group_OBS_tumor.png",
            "infercnv_per_group_OBS_tumor.observations.txt"} <= set(names)


@pytest.fixture
def finished_dirs(tmp_path, carried, standin):  # noqa: F811
    """Both packages' run() into out-dirs, from one object: the i6 HMM in
    samples mode with the Bayesian filter and save_rds (the final object
    and the filtered reports that add_to_seurat reads)."""
    rt, rj, dt, dj = _pair(tmp_path, dict(del_factor=0.6, amp_factor=1.6), HMM=True,
                           HMM_type="i6", BayesMaxPNormal=0.5, save_rds=True,
                           **BAYES_MODES["samples"])
    return dt, dj


def _regions_as_tuples(group_regions):
    return [(gr.group_name, list(gr.cells),
             [(r.name, r.state, r.chrom, r.start, r.end, list(r.genes),
               list(r.gene_states), list(r.gene_starts), list(r.gene_stops))
              for r in gr.regions]) for gr in group_regions]


def test_seurat_export_matches_on_finished_runs(finished_dirs):
    dt, dj = finished_dirs
    ot, grt, ht = tse.load_group_regions_from_out_dir(dt)
    oj, grj, hj = jse.load_group_regions_from_out_dir(dj)
    assert ht == hj == "i6"
    assert ot.cell_names == oj.cell_names
    assert _regions_as_tuples(grt) == _regions_as_tuples(grj)
    assert sum(len(gr.regions) for gr in grj) > 0
    # the port's reader on the JAX package's directory, too
    _o, gr_cross, _h = tse.load_group_regions_from_out_dir(dj)
    assert _regions_as_tuples(gr_cross) == _regions_as_tuples(grj)
    ft, order_t = tse.compute_cnv_features(ot, grt, ht)
    fj, order_j = jse.compute_cnv_features(oj, grj, hj)
    assert order_t == order_j
    for name in order_j:
        np.testing.assert_array_equal(ft[name], fj[name], err_msg=name)
    assert fj["has_loss_chr2"].any()
    tse.add_to_seurat(dt)
    jse.add_to_seurat(dj)
    for f in ("map_metadata_from_infercnv.txt", "top_losses.txt", "top_dupli.txt"):
        with open(os.path.join(dt, f)) as a, open(os.path.join(dj, f)) as b:
            assert a.read() == b.read(), f
