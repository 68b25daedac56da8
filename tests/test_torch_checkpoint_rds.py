"""The port's checkpoints (runner/checkpoint.py), R serialisation
(io/rds.py) and resume against the JAX package's.

- Checkpoints: the same object saved by both packages gives the same
  arrays and the same metadata, and each package's load_step reads the
  other's file back to the same object.
- RDS: write_rds and save_rds_infercnv give gzip-decompressed bytes equal
  to the JAX package's; the port's reader reads both packages' files alike;
  .rds counts (dense matrix, data.frame, dgCMatrix) load through
  load_infercnv_object to the JAX loader's object.
- Resume: tests/test_resume.py's four tests redone on the port's run(),
  with the same monkeypatched call counters (the Viterbi drivers and the
  Bayesian filter must not run again).
"""

import gzip
import json
import os

import numpy as np
import pytest

import infercnv_tpu.io.rds as jrds
import infercnv_tpu.runner.checkpoint as jckpt
import infercnv_tpu_torch.io.rds as trds
import infercnv_tpu_torch.models.bayes as tbayes
import infercnv_tpu_torch.runner.checkpoint as tckpt
from infercnv_tpu.io import loaders as jl
from infercnv_tpu.runner.pipeline import run as jax_run
from infercnv_tpu_torch.interop import infercnv_from_numpy
from infercnv_tpu_torch.io import loaders as tl
from infercnv_tpu_torch.models import hmm as thmm
from infercnv_tpu_torch.runner.config import RunConfig
from infercnv_tpu_torch.runner.pipeline import run as torch_run

from test_pipeline import make_synthetic
from torch_port_util import one_thread_a_pool


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_a_pool():
        yield


@pytest.fixture(scope="module")
def step17(tmp_path_factory):
    """The JAX package's object after step 17 (qnorm subclusters with their
    Ward trees, the hspike, options) and its states; the port's copy."""
    jo = make_synthetic()
    r = jax_run(jo, out_dir=str(tmp_path_factory.mktemp("s17")), HMM=True,
                analysis_mode="subclusters", tumor_subcluster_partition_method="qnorm",
                window_length=21, no_plot=True, save_rds=False, up_to_step=17)
    obj = r.infercnv_obj
    assert obj.hspike is not None and any(
        z is not None for z in obj.tumor_subclusters["hc"].values())
    return obj, np.asarray(r.hmm_states), infercnv_from_numpy(vars(obj))


def _assert_same_object(a, b):
    for k in ("expr", "counts"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    for k in ("names", "chr_names", "chr_ids", "start", "stop"):
        np.testing.assert_array_equal(getattr(a.gene_order, k), getattr(b.gene_order, k))
    assert list(a.cell_names) == list(b.cell_names)
    for k in ("ref_groups", "obs_groups"):
        ga, gb = getattr(a, k), getattr(b, k)
        assert list(ga) == list(gb)
        for g in ga:
            np.testing.assert_array_equal(ga[g], gb[g])
    assert a.options == b.options
    assert (a.tumor_subclusters is None) == (b.tumor_subclusters is None)
    if a.tumor_subclusters is not None:
        sa, sb = a.tumor_subclusters, b.tumor_subclusters
        assert list(sa["subclusters"]) == list(sb["subclusters"])
        for g in sa["subclusters"]:
            assert list(sa["subclusters"][g]) == list(sb["subclusters"][g])
            for n in sa["subclusters"][g]:
                np.testing.assert_array_equal(sa["subclusters"][g][n], sb["subclusters"][g][n])
        assert list(sa["hc"]) == list(sb["hc"])
        for g in sa["hc"]:
            np.testing.assert_array_equal(sa["hc"][g], sb["hc"][g])
    assert (a.hspike is None) == (b.hspike is None)
    if a.hspike is not None:
        _assert_same_object(a.hspike, b.hspike)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_checkpoints_cross_load(step17, tmp_path, writer, reader):
    jo, states, to = step17
    args = tckpt.relevant_args_by_step(RunConfig(out_dir="unused", HMM=True))[16]
    assert args == jckpt.relevant_args_by_step(RunConfig(out_dir="unused", HMM=True))[16]
    paths = {}
    for name, mod, obj in (("jax", jckpt, jo), ("port", tckpt, to)):
        paths[name] = str(tmp_path / f"{name}.npz")
        mod.save_step(obj, paths[name], args, states)
    with np.load(paths["jax"]) as zj, np.load(paths["port"]) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        assert json.loads(str(zj["meta"])) == json.loads(str(zt["meta"]))
        for k in zj.files:
            np.testing.assert_array_equal(zj[k], zt[k], err_msg=k)
            assert zj[k].dtype == zt[k].dtype, k
    load = {"jax": jckpt.load_step, "port": tckpt.load_step}[reader]
    got, got_args, got_states = load(paths[writer])
    want, want_args, want_states = {"jax": jckpt, "port": tckpt}[writer].load_step(paths[writer])
    assert got_args == want_args == json.loads(json.dumps(args))
    np.testing.assert_array_equal(got_states, want_states)
    np.testing.assert_array_equal(got_states, states)
    _assert_same_object(got, want)


def _rds_values():
    """Values of each kind the writer emits, made with either package's
    typed wrappers (RMatrix, RDataFrame, ...) from the same data."""
    reals = np.random.default_rng(4).normal(size=7)
    return {
        "scalars": lambda m: {"a": 1, "b": 2.5, "c": "x", "d": True, "e": None},
        "vectors": lambda m: [np.arange(5, dtype=np.int64), reals,
                              np.array([True, False]), ["p", "q"]],
        "matrix": lambda m: m.RMatrix(np.arange(12.0).reshape(3, 4),
                                      rownames=["r0", "r1", "r2"],
                                      colnames=[f"c{i}" for i in range(4)]),
        "data_frame": lambda m: m.RDataFrame(
            {"chr": m.RFactor(["chr2", "chr1", "chr2"]),
             "start": m.RInt(np.array([1, 5, 9])), "v": np.array([0.5, 1.5, 2.5])},
            rownames=["g0", "g1", "g2"]),
        "s4": lambda m: m.RS4("thing", "pkg", [("slot", m.RString(["a", "b"])),
                                               ("n", 3)]),
    }


@pytest.mark.parametrize("kind", ["scalars", "vectors", "matrix", "data_frame", "s4",
                                  "infercnv"])
def test_rds_bytes_equal_and_read_alike(step17, tmp_path, kind):
    jo, _, to = step17
    paths = {n: str(tmp_path / f"{n}.rds") for n in ("jax", "port")}
    if kind == "infercnv":
        opts = {"analysis_mode": "subclusters", "BayesMaxPNormal": 0.5}
        jrds.save_rds_infercnv(jo, paths["jax"], options=opts)
        trds.save_rds_infercnv(to, paths["port"], options=opts)
    else:
        make = _rds_values()[kind]
        jrds.write_rds(paths["jax"], make(jrds))
        trds.write_rds(paths["port"], make(trds))
    with gzip.open(paths["jax"]) as fj, gzip.open(paths["port"]) as ft:
        assert fj.read() == ft.read()
    if kind == "infercnv":
        for p in paths.values():
            got, want = trds.read_rds_infercnv(p), jrds.read_rds_infercnv(p)
            _assert_same_object(got, want)
            np.testing.assert_array_equal(got.expr, to.expr)
    else:
        # both readers give the same structure (compared through repr,
        # numpy arrays printed in full)
        with np.printoptions(threshold=10**6):
            for p in paths.values():
                assert repr(trds.read_rds(p)) == repr(jrds.read_rds(p))


def _dgc(m, counts, genes, cells):
    import scipy.sparse as sp

    c = sp.csc_matrix(counts)
    return m.RS4("dgCMatrix", "Matrix", [
        ("i", m.RInt(c.indices)), ("p", m.RInt(c.indptr)),
        ("Dim", m.RInt(np.array(c.shape))),
        ("Dimnames", [m.RString(genes), m.RString(cells)]),
        ("x", c.data.astype(np.float64)), ("factors", [])])


@pytest.mark.parametrize("layout", ["matrix", "data_frame", "dgCMatrix"])
def test_rds_counts_load_like_the_reference(tmp_path, layout):
    rng = np.random.default_rng(9)
    G, C = 80, 24
    counts = rng.poisson(rng.gamma(2.0, 20.0, G)[:, None] * np.ones((1, C))).astype(np.float64)
    counts[rng.random((G, C)) < 0.3] = 0.0
    genes = [f"G{i}" for i in range(G)]
    cells = [f"cell{j}" for j in range(C)]
    path = str(tmp_path / "counts.rds")
    if layout == "matrix":
        trds.write_rds(path, trds.RMatrix(counts, rownames=genes, colnames=cells))
    elif layout == "data_frame":
        trds.write_rds(path, trds.RDataFrame({c: counts[:, j] for j, c in enumerate(cells)},
                                             rownames=genes))
    else:
        trds.write_rds(path, _dgc(trds, counts, genes, cells))
    order = tmp_path / "order.txt"
    order.write_text("".join(f"{g}\tchr{1 + i // 20}\t{1000 * (i % 20) + 1}\t"
                             f"{1000 * (i % 20) + 500}\n" for i, g in enumerate(genes)))
    ann = tmp_path / "ann.txt"
    ann.write_text("".join(f"{c}\t{'normal' if j < 8 else 'tumour'}\n"
                           for j, c in enumerate(cells)))
    kw = dict(counts_path=path, gene_order_path=str(order),
              annotations_path=str(ann), ref_group_names=["normal"])
    got, want = tl.load_infercnv_object(**kw), jl.load_infercnv_object(**kw)
    _assert_same_object(got, infercnv_from_numpy(vars(want)))
    np.testing.assert_array_equal(got.counts, counts.T.astype(got.counts.dtype))


# ---- resume: tests/test_resume.py on the port's run() ---------------------

RUN_ARGS = dict(HMM=True, HMM_type="i6", analysis_mode="samples", denoise=True,
                HMM_report_by="consensus", window_length=21, no_plot=True,
                BayesMaxPNormal=0.5)


def _synthetic(**kw):
    return infercnv_from_numpy(vars(make_synthetic(**kw)))


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    obj = _synthetic()
    out = str(tmp_path_factory.mktemp("resume"))
    with one_thread_a_pool():
        res = torch_run(obj, out_dir=out, device="cpu", save_rds=True, **RUN_ARGS)
    return obj, res, out


def test_load_step_restores_counts_hc_options(first_run, tmp_path):
    """load_step restores the raw counts (not expr), the Ward trees and the
    options."""
    obj, res, out = first_run
    final = res.infercnv_obj
    path = str(tmp_path / "step.npz")
    args = {"s1.x": 1}
    tckpt.save_step(final, path, args)
    restored, saved_args, _ = tckpt.load_step(path)
    assert saved_args == args
    np.testing.assert_array_equal(restored.counts, final.counts)
    assert not np.array_equal(restored.counts, restored.expr)
    assert restored.options.get("counts_md5") == final.options.get("counts_md5")
    if final.tumor_subclusters and final.tumor_subclusters.get("hc"):
        for g, link in final.tumor_subclusters["hc"].items():
            if link is None:
                continue
            np.testing.assert_array_equal(
                np.asarray(restored.tumor_subclusters["hc"][g]), np.asarray(link))


def test_resume_skips_hmm_recompute(first_run, monkeypatch):
    """A second run() over a completed out_dir reuses the 17->19 chain:
    neither the Viterbi drivers nor the Gibbs sampler run again."""
    obj, res, out = first_run

    def _boom(*a, **k):
        raise AssertionError("HMM prediction re-ran despite valid checkpoint")

    monkeypatch.setattr(thmm, "predict_hmm_on_groups", _boom)
    monkeypatch.setattr(thmm, "predict_hmm_on_cells", _boom)
    monkeypatch.setattr(tbayes, "bayesian_filter_states", _boom)
    res2 = torch_run(_synthetic(), out_dir=out, device="cpu", save_rds=True, **RUN_ARGS)
    np.testing.assert_array_equal(res2.hmm_states, res.hmm_states)
    np.testing.assert_allclose(res2.infercnv_obj.expr, res.infercnv_obj.expr, atol=1e-6)
    steps = {r["step"] for r in res2.timer.records}
    assert not steps & {"17_hmm", "18_bayes", "04-14_engine_transform"}


def test_resume_reruns_bayes_when_threshold_changes(first_run, monkeypatch):
    """Changing BayesMaxPNormal invalidates step 19 but not step 17: the raw
    Viterbi states are reused, the Bayes filter runs again."""
    obj, res, out = first_run

    def _boom(*a, **k):
        raise AssertionError("HMM prediction re-ran despite valid step-17 checkpoint")

    monkeypatch.setattr(thmm, "predict_hmm_on_groups", _boom)
    res2 = torch_run(_synthetic(), out_dir=out, device="cpu", save_rds=True,
                     **{**RUN_ARGS, "BayesMaxPNormal": 0.3})
    assert res2.hmm_states is not None
    assert res2.bayes_result is not None  # Bayes actually re-ran


def test_changed_counts_forces_recompute(first_run):
    """Same arguments and a different input matrix reuse no checkpoint (the
    counts md5 guard)."""
    obj, res, out = first_run
    obj2 = _synthetic(seed=99)
    assert obj2.options["counts_md5"] != obj.options["counts_md5"]
    cfg = RunConfig(out_dir="unused", **RUN_ARGS)
    step, restored, states = tckpt.scan_resume(out, cfg, ".HMMi6", obj2.options["counts_md5"])
    assert step == 0 and restored is None
    step, restored, states = tckpt.scan_resume(out, cfg, ".HMMi6", obj.options["counts_md5"])
    assert step >= 17 and states is not None
