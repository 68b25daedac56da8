"""run() at the 1M-cell configuration's options (benchmarks/scale1m_run.py:
137-144) against the JAX package's run(), on the CPU at toy size: chunk
downloads narrowed to float16 or bfloat16 (``engine_transfer_dtype``; the
fused kernel stores the narrow dtype itself where no residual is kept on
the device), the residual in a disk-backed float32 memmap
(``residual_memmap_gb``), lazy per-group slicing in step 15 and the
block-wise in-place denoise of step 22.

The last two switch on by themselves above 2e9 matrix elements
(``partition.LAZY_SLICE_ELEMENTS``, ``pipeline.INPLACE_DENOISE_ELEMENTS``);
here the port's constants are set to 0, and so is
``pipeline.KEEP_RESIDUAL_BYTES`` where a Leiden step 15 must take the host
route at toy size.  The reference's literals cannot be set, so its runs
take the eager slice and the out-of-place denoise: the port's forced runs
must give the same results, since those routes change how rows are copied,
not the arithmetic.

Tolerances: with float16 downloads, one float16 ulp of the reference's
value (2^-10 |x|), except where the two packages' float32 residuals (within
2e-5 of each other) sat on either side of the denoise band's edge, so that
one run denoised a value the other kept; those are counted and bounded.
With bfloat16 downloads the two residuals round to the same bfloat16
values, so the results are equal; in every forced route the reference's
tolerance rtol = atol = 2e-5 holds.  HMM states, subclusters and the step-17
region reports equal.  The i6 runs carry the reference's hspike and trend
fits across, and the Leiden runs its PCA draw (tests/test_torch_pipeline.py,
``carried``)."""

import filecmp
import logging
import os

import numpy as np
import pytest

import infercnv_tpu.ops.transforms as jT
import infercnv_tpu.runner.pipeline as jp
import infercnv_tpu_torch.ops.transforms as tT
import infercnv_tpu_torch.runner.pipeline as tp
from infercnv_tpu_torch.interop import infercnv_from_numpy
from infercnv_tpu_torch.subcluster import partition as tpart
from infercnv_tpu_torch.subcluster import pca as tpca

from test_pipeline import make_synthetic
from test_torch_pca_knn import jax_omega
from test_torch_pipeline import carried  # noqa: F401 (a fixture)
from torch_port_util import one_thread_a_pool

#: the reference test's keywords (tests/test_scale_paths.py:135-138)
KW = dict(HMM=True, HMM_type="i6", analysis_mode="subclusters",
          tumor_subcluster_partition_method="leiden", denoise=True,
          window_length=21, no_plot=True, save_rds=False, BayesMaxPNormal=0)
TOL = dict(rtol=2e-5, atol=2e-5)
MEMMAP = "_residual.f32.memmap"
#: at most this share of the values may sit on the denoise band's edge
EDGE_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_a_pool():
        yield


@pytest.fixture(autouse=True)
def _handed_omega(monkeypatch):
    monkeypatch.setattr(tpca, "range_omega", jax_omega)


def _runs(tmp_path, jax_kw=None, port_kw=None):
    """The reference's run() and the port's on make_synthetic()'s object."""
    jo = make_synthetic()
    to = infercnv_from_numpy(vars(jo))
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    rj = jp.run(jo, out_dir=dj, **{**KW, **(jax_kw or {})})
    rt = tp.run(to, out_dir=dt, device="cpu", **{**KW, **(port_kw or {})})
    return rt, rj, dt, dj


def _port_run(tmp_path, name, **kw):
    out = str(tmp_path / name)
    return tp.run(infercnv_from_numpy(vars(make_synthetic())), out_dir=out,
                  device="cpu", **{**KW, **kw}), out


def _reports(d):
    return sorted(f for f in os.listdir(d) if f.startswith("17_HMM_pred"))


def _assert_same_calls(rt, rj, dt, dj):
    """States, subclusters and the step-17 region reports equal."""
    np.testing.assert_array_equal(rt.hmm_states, rj.hmm_states)
    st, sj = (r.infercnv_obj.tumor_subclusters["subclusters"] for r in (rt, rj))
    assert list(st) == list(sj)
    for g in sj:
        assert list(st[g]) == list(sj[g])
        for n in sj[g]:
            np.testing.assert_array_equal(st[g][n], sj[g][n])
    reports = _reports(dj)
    assert len(reports) == 4 and reports == _reports(dt)
    for f in reports:
        assert filecmp.cmp(os.path.join(dt, f), os.path.join(dj, f), shallow=False), f


def _centre_and_edge(a):
    """A denoised matrix's band centre (its most frequent value) and the
    distance from it of the nearest value the band kept."""
    vals, counts = np.unique(a, return_counts=True)
    centre = vals[counts.argmax()]
    return centre, np.abs(a[a != centre] - centre).min()


def _band_edge_flips(got, want, tol):
    """Where |got - want| > tol, the places where one run holds its band's
    centre and the other's value lies within tol of its band's edge (one
    run denoised a value the other kept).  Returns (those places, the
    rest)."""
    far = np.abs(got - want) > tol
    (cg, eg), (cw, ew) = _centre_and_edge(got), _centre_and_edge(want)
    flips = far & (((got == cg) & (np.abs(np.abs(want - cw) - ew) <= tol))
                   | ((want == cw) & (np.abs(np.abs(got - cg) - eg) <= tol)))
    return flips, far & ~flips


@pytest.mark.parametrize("dtype,method", [("float16", "leiden"), ("float16", "qnorm"),
                                          ("bfloat16", "leiden")])
def test_narrow_transfer_memmap_matches_the_reference(tmp_path, carried, caplog,  # noqa: F811
                                                      dtype, method):
    opts = dict(engine_transfer_dtype=dtype, residual_memmap_gb=1e-9,
                tumor_subcluster_partition_method=method)
    with caplog.at_level(logging.INFO, logger="infercnv_tpu_torch"):
        rt, rj, dt, dj = _runs(tmp_path, opts, opts)
    for d in (dt, dj):
        assert os.path.getsize(os.path.join(d, MEMMAP)) == 4 * rt.infercnv_obj.expr.size
    # a Leiden step 15 keeps the f32 residual on the device, so the chunks
    # are cast on their way down; qnorm lets the kernel store the dtype
    direct = f"engine chunk downloads as {dtype} (kernel-direct)"
    assert (direct in caplog.text) == (method == "qnorm")
    et, ej = rt.infercnv_obj.expr, rj.infercnv_obj.expr
    if dtype == "float16":
        tol = 2.0 ** -10 * np.abs(ej)
        flips, rest = _band_edge_flips(et, ej, tol)
        assert not rest.any(), np.abs(et - ej)[rest].max()
        assert flips.mean() <= EDGE_SHARE, int(flips.sum())
    else:
        np.testing.assert_array_equal(et, ej)
    _assert_same_calls(rt, rj, dt, dj)


@pytest.mark.parametrize("method", ["qnorm", "leiden"])
def test_forced_lazy_slice_matches_the_eager_slice(tmp_path, carried, monkeypatch,  # noqa: F811
                                                   caplog, method):
    """The port's lazy slice (forced) against the reference's eager slice
    and the port's own (with the Leiden, both ports on the host route)."""
    monkeypatch.setattr(tp, "KEEP_RESIDUAL_BYTES", 0)
    # both port runs start from the reference's hspike as built
    monkeypatch.setattr(tp, "build_hspike", lambda *a, **k: carried["hspike"].shallow_copy())
    lazy_above = tpart.LAZY_SLICE_ELEMENTS
    monkeypatch.setattr(tpart, "LAZY_SLICE_ELEMENTS", 0)
    with caplog.at_level(logging.INFO, logger="infercnv_tpu_torch"):
        rt, rj, dt, dj = _runs(tmp_path, dict(tumor_subcluster_partition_method=method),
                               dict(tumor_subcluster_partition_method=method))
    assert "lazy per-group slicing" in caplog.text and tpart.ROWS_FROM == "host"
    caplog.clear()
    monkeypatch.setattr(tpart, "LAZY_SLICE_ELEMENTS", lazy_above)
    eager, _ = _port_run(tmp_path, "eager", tumor_subcluster_partition_method=method)
    assert "lazy per-group slicing" not in caplog.text
    np.testing.assert_allclose(rt.infercnv_obj.expr, rj.infercnv_obj.expr, **TOL)
    _assert_same_calls(rt, rj, dt, dj)
    np.testing.assert_array_equal(rt.infercnv_obj.expr, eager.infercnv_obj.expr)
    np.testing.assert_array_equal(rt.hmm_states, eager.hmm_states)
    assert (rt.infercnv_obj.tumor_subclusters["subclusters"].keys()
            == eager.infercnv_obj.tumor_subclusters["subclusters"].keys())


def test_inplace_denoise_on_a_memmap_matches_the_reference(tmp_path):
    """Two 16,384-row blocks and a part of one, written through the memmap;
    the memmap itself comes back."""
    rng = np.random.default_rng(11)
    x = rng.normal(1.0, 0.1, (40_000, 6)).astype(np.float32)
    ref_idx = np.arange(5_000, 12_000)
    mm = np.memmap(str(tmp_path / "x.memmap"), dtype=np.float32, mode="w+", shape=x.shape)
    mm[:] = x
    got = tT.clear_noise_via_ref_mean_sd(mm, ref_idx, 1.5, inplace=True)
    assert got is mm
    want = np.asarray(jT.clear_noise_via_ref_mean_sd(x, ref_idx, 1.5))
    np.testing.assert_allclose(np.asarray(mm), want, **TOL)
    assert (want == want[ref_idx[0]]).sum() > x.size // 4    # the band took values
    mm.flush()
    back = np.fromfile(str(tmp_path / "x.memmap"), np.float32).reshape(x.shape)
    np.testing.assert_array_equal(back, np.asarray(mm))


def test_run_inplace_denoise_matches_the_reference(tmp_path, carried, monkeypatch):  # noqa: F811
    """run() with the in-place denoise forced on the memmap residual, and
    lazy slicing forced, against the reference's default run."""
    monkeypatch.setattr(tp, "INPLACE_DENOISE_ELEMENTS", 0)
    monkeypatch.setattr(tpart, "LAZY_SLICE_ELEMENTS", 0)
    rt, rj, dt, dj = _runs(tmp_path, port_kw=dict(residual_memmap_gb=1e-9,
                                                  tumor_subcluster_partition_method="qnorm"),
                           jax_kw=dict(tumor_subcluster_partition_method="qnorm"))
    et = rt.infercnv_obj.expr
    assert isinstance(et, np.memmap) and et.filename == os.path.join(dt, MEMMAP)
    np.testing.assert_allclose(et, rj.infercnv_obj.expr, **TOL)
    _assert_same_calls(rt, rj, dt, dj)
