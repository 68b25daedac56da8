"""Host memory of run() at scale (ROADMAP C5), on the CPU at toy size.

A disk memmap's pages count in the process's resident set once touched, so
run() moves such a matrix's rows through its file, not its mapping
(``utils/memmap``: ``read_rows``, ``gather_rows``, ``write_rows``): the
caller's counts in step 2, the residual's rows as the engine drains them,
the reference rows of step 15's z-score filter, each block of the lazy
per-group slice, each group's rows of step 17's means, the Bayesian
filter's rows and each block of the in-place denoise.  Step 15's host VST
accumulates its moments over row blocks (``pca.VST_BLOCK_ROWS``).  None of
it may change a result: the runs here, every route forced by the port's
module constants as tests/test_torch_scale_paths.py forces them, are held
to the JAX package's run() (final expr within 2e-5, the same subclusters,
byte-equal step-17 reports) and to the port's unforced route (equal)."""

import filecmp
import os

import numpy as np
import pytest
import torch

import infercnv_tpu.ops.transforms as jT
import infercnv_tpu.runner.pipeline as jp
import infercnv_tpu.utils.splines as jsplines
import infercnv_tpu_torch.ops.transforms as tT
import infercnv_tpu_torch.runner.pipeline as tp
from infercnv_tpu.subcluster import pca as jpca
from infercnv_tpu_torch.core.object import InferCNV
from infercnv_tpu_torch.interop import infercnv_from_numpy
from infercnv_tpu_torch.runner.config import RunConfig
from infercnv_tpu_torch.subcluster import partition as tpart
from infercnv_tpu_torch.subcluster import pca as tpca
from infercnv_tpu_torch.utils import profiling
from infercnv_tpu_torch.utils.memmap import _mapping_address, release, write_rows

from test_pipeline import make_synthetic
from test_torch_pca_knn import jax_omega
from test_torch_pipeline import carried  # noqa: F401 (a fixture)
from test_torch_scale_programs import p1m_run
from torch_port_util import one_thread_a_pool

KW = dict(HMM=True, HMM_type="i6", analysis_mode="subclusters",
          tumor_subcluster_partition_method="leiden", denoise=True,
          window_length=21, no_plot=True, save_rds=False, BayesMaxPNormal=0)
TOL = dict(rtol=2e-5, atol=2e-5)
#: a released mapping keeps at most this share of its bytes resident
RESIDENT_SHARE = 1 / 8


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_a_pool():
        yield


def mapping_rss(a) -> int:
    """Resident bytes of the mapping behind the memmap `a`
    (/proc/self/smaps)."""
    base = _mapping_address(a._mmap)
    inside = False
    with open("/proc/self/smaps") as f:
        for line in f:
            head = line.split()[0]
            if not head.endswith(":") and "-" in head:
                lo, hi = (int(v, 16) for v in head.split("-"))
                inside = lo <= base < hi
            elif inside and line.startswith("Rss:"):
                return int(line.split()[1]) * 1024
    raise AssertionError("the memmap's mapping is not in /proc/self/smaps")


def _on_disk(a: np.ndarray, path) -> np.memmap:
    """`a` as a read-only disk memmap of a .npy file, its pages dropped."""
    np.save(path, a)
    return np.load(path, mmap_mode="r")


def test_release_keeps_the_data(tmp_path):
    """Written rows go back to the file; their pages leave the mapping;
    arrays that are not shared disk memmaps are left alone."""
    x = np.arange(4096 * 512, dtype=np.float32).reshape(4096, 512)
    mm = np.memmap(tmp_path / "x.f32", np.float32, "w+", shape=x.shape)
    mm[:] = x
    assert mapping_rss(mm) >= mm.nbytes
    for b in range(0, 4096, 1000):
        release(mm, b, b + 1000)
    assert mapping_rss(mm) == 0
    np.testing.assert_array_equal(mm, x)
    np.testing.assert_array_equal(np.fromfile(tmp_path / "x.f32", np.float32).reshape(x.shape), x)
    release(mm[100:300], 0, 50)      # a view of the mapping
    cow = np.memmap(tmp_path / "x.f32", np.float32, "c", shape=x.shape)
    cow[0, 0] = -1.0
    release(cow)                      # copy-on-write: its private page stays
    assert cow[0, 0] == -1.0 and mm[0, 0] == 0.0
    y = x.copy()
    release(y)
    np.testing.assert_array_equal(y, x)


def test_rows_written_through_the_file(tmp_path):
    """write_rows puts rows into a disk memmap through its file: the mapping
    reads them, and none of them is resident in it after."""
    x = np.arange(4096 * 512, dtype=np.float32).reshape(4096, 512)
    mm = np.memmap(tmp_path / "x.f32", np.float32, "w+", shape=x.shape)
    mm[:5] = -1.0                     # pages the mapping already holds
    for b in range(0, 4096, 1000):
        write_rows(mm, b, x[b:b + 1000].astype(np.float16))
    assert mapping_rss(mm) == 0
    np.testing.assert_array_equal(mm, x.astype(np.float16).astype(np.float32))
    with pytest.raises(ValueError):
        write_rows(mm, 4000, x[:100])
    ro = np.memmap(tmp_path / "x.f32", np.float32, "r", shape=x.shape)
    with pytest.raises(ValueError):
        write_rows(ro, 0, x[:1])
    y = np.zeros_like(x)
    write_rows(y, 7, x[:3])
    np.testing.assert_array_equal(y[7:10], x[:3])


def test_engine_drain_writes_through_the_file(tmp_path):
    """Steps 4-14 on the engine, its chunks drained into a ~64 MB residual
    memmap (forced): the mapping keeps no more than an eighth of its bytes
    resident after it, and reads back the residual of an in-memory run."""
    go, counts, ref_groups, tumor_groups, _ = p1m_run.synth_counts_streamed(8192, G=2000)

    def engine_pass(name, **kw):
        obj = InferCNV(expr=counts, counts=counts, gene_order=go,
                       cell_names=[f"c{i}" for i in range(8192)],
                       ref_groups=ref_groups, obs_groups=tumor_groups)
        cfg = RunConfig(out_dir=str(tmp_path / name), HMM=False, analysis_mode="samples",
                        engine_chunk_cells=2048, **kw)
        os.makedirs(cfg.out_dir)
        timer = profiling.StepTimer()
        tp._run_engine_residual(obj, cfg, timer, torch.device("cpu"))
        return obj.expr, {r["step"]: r for r in timer.records}

    resid, steps = engine_pass("memmap", residual_memmap_gb=1e-9)
    assert isinstance(resid, np.memmap) and 60e6 < resid.nbytes < 70e6
    assert mapping_rss(resid) <= RESIDENT_SHARE * resid.nbytes
    in_memory, _ = engine_pass("ram")
    assert not isinstance(in_memory, np.memmap)
    np.testing.assert_array_equal(resid, in_memory)
    assert {"rss_gb", "anon_gb", "file_gb", "peak_gb"} <= set(steps["04-14_engine_transform"])


def test_step_two_reads_the_callers_memmap_through_its_file(tmp_path):
    """Step 2's filters and its gene-filtered copy on counts the caller
    keeps in a read-only disk memmap (9,000 rows, past one 8,192-row
    block): the reference's genes and values, no page of the file left
    resident, the caller's matrix unchanged."""
    go, counts, ref_groups, tumor_groups, _ = p1m_run.synth_counts_streamed(9000, G=300)
    counts[:, :7] = 0                                  # genes for the filters to drop
    on_disk = _on_disk(counts, tmp_path / "counts.npy")
    drop1 = tT.below_min_mean_expr_cutoff(on_disk, 1.0)
    drop2 = tT.genes_below_min_cells_ref(on_disk, 3)
    np.testing.assert_array_equal(drop1, jT.below_min_mean_expr_cutoff(counts, 1.0))
    np.testing.assert_array_equal(drop2, jT.genes_below_min_cells_ref(counts, 3))
    assert drop1.size >= 7
    obj = InferCNV(expr=on_disk, counts=on_disk, gene_order=go,
                   cell_names=[f"c{i}" for i in range(9000)],
                   ref_groups=ref_groups, obs_groups=tumor_groups)
    obj.remove_genes(np.union1d(drop1, drop2))
    keep = np.setdiff1d(np.arange(300), np.union1d(drop1, drop2))
    assert not isinstance(obj.expr, np.memmap) and obj.counts is obj.expr
    assert mapping_rss(on_disk) <= RESIDENT_SHARE * on_disk.nbytes
    np.testing.assert_array_equal(obj.expr, counts[:, keep])
    np.testing.assert_array_equal(on_disk, counts)


def _assert_same_subclusters(a, b):
    sa, sb = (r.infercnv_obj.tumor_subclusters["subclusters"] for r in (a, b))
    assert list(sa) == list(sb)
    for g in sb:
        assert list(sa[g]) == list(sb[g])
        for n in sb[g]:
            np.testing.assert_array_equal(sa[g][n], sb[g][n])


def _reports(d):
    return sorted(f for f in os.listdir(d) if f.startswith("17_HMM_pred"))


def test_run_through_the_files_matches_the_reference(tmp_path, carried,  # noqa: F811
                                                       monkeypatch):
    """Every such site on a forced route: the caller's counts in a
    read-only disk memmap, the residual in a disk memmap, the host route of
    a Leiden step 15 with the lazy slice in blocks of 7 rows, step 17's
    group means, the in-place denoise.  Held to the reference's run() and
    to the port's unforced slicing and denoise on in-memory counts."""
    monkeypatch.setattr(tpca, "range_omega", jax_omega)
    monkeypatch.setattr(tp, "KEEP_RESIDUAL_BYTES", 0)
    monkeypatch.setattr(tp, "build_hspike", lambda *a, **k: carried["hspike"].shallow_copy())
    jo = make_synthetic()
    dj = str(tmp_path / "jax")
    rj = jp.run(jo, out_dir=dj, **KW)

    def port(name, **kw):
        to = infercnv_from_numpy(vars(make_synthetic()))
        if name == "forced":
            to.expr = to.counts = _on_disk(np.asarray(to.expr), tmp_path / "counts.npy")
        out = str(tmp_path / name)
        return tp.run(to, out_dir=out, device="cpu", **KW, **kw), out, to

    with monkeypatch.context() as m:
        m.setattr(tpart, "LAZY_SLICE_ELEMENTS", 0)
        m.setattr(tpart, "LAZY_SLICE_BLOCK_ROWS", 7)
        m.setattr(tp, "INPLACE_DENOISE_ELEMENTS", 0)
        rt, dt, _ = port("forced", residual_memmap_gb=1e-9)
    plain, _, _ = port("unforced")

    et = rt.infercnv_obj.expr
    assert isinstance(et, np.memmap) and tpart.ROWS_FROM == "host"
    assert mapping_rss(et) <= RESIDENT_SHARE * et.nbytes
    np.testing.assert_allclose(et, rj.infercnv_obj.expr, **TOL)
    _assert_same_subclusters(rt, rj)
    np.testing.assert_array_equal(rt.hmm_states, rj.hmm_states)
    reports = _reports(dj)
    assert reports and reports == _reports(dt)
    for f in reports:
        assert filecmp.cmp(os.path.join(dt, f), os.path.join(dj, f), shallow=False), f
    np.testing.assert_array_equal(et, plain.infercnv_obj.expr)
    np.testing.assert_array_equal(rt.hmm_states, plain.hmm_states)
    _assert_same_subclusters(rt, plain)


@pytest.mark.parametrize("shape,block", [((3000, 500), 333), ((1200, 2600), 64)])
def test_blocked_vst_matches_the_reference(monkeypatch, shape, block):
    """The port's VST moments over row blocks against the reference's
    whole-matrix numpy (infercnv_tpu/subcluster/pca.py:66-67): the
    mean-variance trend's inputs within 1e-12 relative, the same features."""
    rng = np.random.default_rng(block)
    x = (rng.gamma(2.0, 0.1, shape) + 0.9).astype(np.float32)
    seen = {}

    def recording(name, fit):
        def f(log_mu, log_var, *a, **k):
            seen[name] = (np.array(log_mu), np.array(log_var))
            return fit(log_mu, log_var, *a, **k)
        return f

    monkeypatch.setattr(jsplines, "fit_smoothing_spline",
                        recording("jax", jsplines.fit_smoothing_spline))
    monkeypatch.setattr(tpca, "fit_smoothing_spline",
                        recording("torch", tpca.fit_smoothing_spline))
    monkeypatch.setattr(tpca, "VST_BLOCK_ROWS", block)
    n_features = shape[1] // 5
    got = tpca.variable_features_vst(x, n_features)
    want = np.asarray(jpca.variable_features_vst(x, n_features))
    np.testing.assert_array_equal(got, want)
    for i in range(2):   # log10(mean), log10(var)
        np.testing.assert_allclose(10.0 ** seen["torch"][i], 10.0 ** seen["jax"][i],
                                   rtol=1e-12, atol=0)


def test_counts_from_hands_a_read_only_disk_memmap(tmp_path):
    """torch_scale1m_run.counts_from with a cache path: the counts drawn into
    the file, then read back from it as a read-only memmap; a second call
    reads the file.  Without a path they are drawn into host memory."""
    path = str(tmp_path / "c.npy")
    counts = p1m_run.counts_from(300, path)[1]
    assert isinstance(counts, np.memmap) and counts.mode == "r"
    want = p1m_run.synth_counts_streamed(300)[1]
    np.testing.assert_array_equal(counts, want)
    np.testing.assert_array_equal(p1m_run.counts_from(300, path)[1], want)
    in_memory = p1m_run.counts_from(300)[1]
    assert not isinstance(in_memory, np.memmap)
    np.testing.assert_array_equal(in_memory, want)


def test_timing_line_splits_the_resident_set():
    mem = profiling.memory_gb()
    assert {"rss_gb", "anon_gb", "file_gb", "peak_gb"} <= set(mem)
    assert mem["anon_gb"] <= mem["rss_gb"] and mem["file_gb"] <= mem["rss_gb"]
    assert mem["peak_gb"] >= 0.9 * mem["rss_gb"]
    assert profiling.memory_text(mem).startswith("rss ")
