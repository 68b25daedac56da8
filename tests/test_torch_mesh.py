"""The port's cell mesh (parallel/stats.CellMesh on CPU shards) against the
JAX package's mesh on its 8 virtual CPU devices (conftest.py) and against
numpy.

Tolerances: the sharded median exact (numpy's value); the quantile's order
statistics exact and its float32 interpolation equal to the reference's
formula on them (and within float32 rounding of np.quantile of the values
in float64: np.quantile of float32 values rounds q itself to float32, which
the reference avoids on purpose); group means within 1e-6 relative, the
variance within 1e-6 of the mean square (the reference's float32 formula
subtracts two terms of that size; the port sums in float64);
residuals rtol = atol = 2e-5 (the engine tests' tolerance), Viterbi states
exact; run() expr within 1e-5 (tests/test_run_mesh.py)."""

import numpy as np
import pytest
import torch

from infercnv_tpu.parallel import stats as jstats
from infercnv_tpu.parallel.engine import CnvEngine as JaxEngine
from infercnv_tpu.parallel.engine import EngineConfig as JaxConfig
from infercnv_tpu.parallel.engine import make_cell_mesh as jax_mesh
import infercnv_tpu.models.hmm as jhmm
import infercnv_tpu.runner.pipeline as jp
from infercnv_tpu_torch.interop import infercnv_from_numpy, ref_stats_from_numpy
import infercnv_tpu_torch.models.hmm as thmm
import infercnv_tpu_torch.runner.pipeline as tp
from infercnv_tpu_torch.parallel import stats as tstats
from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig, make_cell_mesh

from test_run_mesh import KW, _toy_obj
from torch_port_util import gene_orders, hmms, np_, one_thread_a_pool


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_a_pool():
        yield


def _values(n, seed=0):
    """Float32 values with ties, negatives, a -0.0 and a +0.0."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0.0, 2.0, n).astype(np.float32)
    v[: n // 4] = np.round(v[: n // 4])          # ties
    v[-1], v[-2] = -0.0, 0.0
    return v


def _exact_quantile(v, q):
    """The reference's type-7 arithmetic on numpy's exact order statistics."""
    n = v.size
    h = (n - 1) * float(q)
    lo_idx = int(np.floor(h))
    s = np.sort(v)
    lo, hi = s[lo_idx], s[min(lo_idx + 1, n - 1)]
    return lo + np.float32(h - lo_idx) * (hi - lo)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_sharded_order_statistics_match(n_shards):
    v = _values(24 * 8, seed=n_shards)
    mesh = make_cell_mesh(n_shards, device="cpu")
    jm = jax_mesh(n_shards)
    jv = jstats.put_cell_sharded(v, jm)
    med = float(tstats.sharded_median(v, mesh))
    assert med == float(np.median(v))
    assert med == float(jstats.sharded_median(jv, jm))
    for q in (0.01, 0.5, 0.99):
        got = tstats.sharded_quantile(v, q, mesh)
        assert got.dtype == torch.float32
        assert float(got) == float(_exact_quantile(v, q))
        assert float(got) == float(jstats.sharded_quantile(jv, q, jm))
        np.testing.assert_allclose(float(got), np.quantile(v.astype(np.float64), q),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [25, 26])
def test_uneven_shards_and_odd_counts(n):
    """Order statistics over shards of unequal lengths (made by hand) and
    odd or even counts: the select only sums each shard's counts."""
    v = _values(n, seed=n)
    t = torch.from_numpy(v)
    mesh = tstats.CellMesh(["cpu"] * 3)
    sh = tstats.CellSharded([t[:5], t[5:17], t[17:]], mesh)
    assert float(tstats.sharded_median(sh, mesh)) == float(np.median(v))
    for q in (0.0, 0.01, 0.37, 0.99, 1.0):
        assert float(tstats.sharded_quantile(sh, q, mesh)) == float(_exact_quantile(v, q))


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_sharded_group_gene_stats_match(n_shards):
    rng = np.random.default_rng(n_shards)
    C, G, K = 48, 37, 3
    x = rng.normal(1.5, 0.3, (C, G)).astype(np.float32)
    onehot = np.zeros((K, C), np.float32)
    onehot[rng.integers(0, K, C), np.arange(C)] = 1
    mesh = make_cell_mesh(n_shards, device="cpu")
    mu, sd = tstats.sharded_group_gene_stats(x, onehot, mesh)
    jm = jax_mesh(n_shards)
    jmu, jsd = jstats.sharded_group_gene_stats(
        jstats.put_cell_sharded(x, jm),
        jstats.put_cell_sharded(onehot.T, jm).T, jm)
    x64 = x.astype(np.float64)
    for k in range(K):
        sel = x64[onehot[k] > 0]
        np.testing.assert_allclose(np_(mu)[k], sel.mean(axis=0), rtol=1e-6)
        np.testing.assert_allclose(np_(mu)[k], np_(jmu)[k], rtol=1e-6)
        msq = (sel * sel).mean(axis=0)
        np.testing.assert_allclose(np_(sd)[k] ** 2, sel.var(axis=0, ddof=1),
                                   rtol=0, atol=1e-6 * msq.max())
        np.testing.assert_allclose(np_(sd)[k] ** 2, np_(jsd)[k] ** 2,
                                   rtol=0, atol=1e-6 * msq.max())
    # the same statistics from a CellSharded one-hot of [C, K]
    mu2, sd2 = tstats.sharded_group_gene_stats(
        tstats.put_cell_sharded(x, mesh), tstats.put_cell_sharded(onehot.T, mesh), mesh)
    assert torch.equal(mu2, mu) and torch.equal(sd2, sd)


def test_put_cell_sharded_and_to_host():
    mesh = make_cell_mesh(4, device="cpu")
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    sh = tstats.put_cell_sharded(x, mesh)
    assert [s.shape[0] for s in sh.shards] == [2] * 4 and sh.shape == (8, 3)
    np.testing.assert_array_equal(tstats.to_host(sh), x)
    with pytest.raises(ValueError, match="equal shards"):
        tstats.put_cell_sharded(x[:7], mesh)
    assert mesh.collective_device().type == "cpu" and mesh.n_shards == 4


@pytest.fixture(scope="module")
def small():
    """tests/test_parallel.py's 3 x 96 genes and 64 cells with a planted
    deletion (as tests/test_torch_engine.py builds it)."""
    rng = np.random.default_rng(3)
    lens = [96, 96, 96]
    G = sum(lens)
    counts = rng.poisson(
        rng.gamma(2.0, 30.0, G)[None, :] * np.ones((64, 1))).astype(np.float32)
    counts[32:, 96:192] = np.maximum(counts[32:, 96:192] * 0.5, 0)
    nf = float(np.median(counts.sum(axis=1)))
    onehot_ref = np.zeros((2, 16), np.float32)
    onehot_ref[0, :8] = 1
    onehot_ref[1, 8:] = 1
    return lens, counts, nf, onehot_ref


def test_engine_chunk_steps_on_8_shards(small):
    lens, counts, nf, onehot_ref = small
    jgo, tgo = gene_orders(lens)
    jh, th = hmms()
    cfg = dict(window_length=11)
    je = JaxEngine(jgo, jh, JaxConfig(**cfg), mesh=jax_mesh(8), use_pallas=False)
    te = CnvEngine(tgo, th, EngineConfig(**cfg), mesh=make_cell_mesh(8, device="cpu"))
    t1 = CnvEngine(tgo, th, EngineConfig(**cfg), device="cpu")
    ml, mr, nb = je.ref_stats(counts[:16], nf, onehot_ref)
    st = ref_stats_from_numpy(np_(ml), np_(mr), np_(nb), device="cpu")
    tol = dict(rtol=2e-5, atol=2e-5)
    # transform
    got = tstats.to_host(te.transform_chunk(counts, nf, *st[:2]))
    np.testing.assert_allclose(got, np_(t1.transform_chunk(counts, nf, *st[:2])), **tol)
    np.testing.assert_allclose(got, jstats.to_host(je.transform_chunk(
        jstats.put_cell_sharded(counts, je.mesh), nf, ml, mr)), **tol)
    # full chunk: the per-cell Viterbi on each shard
    tr, ts = te.full_chunk(counts, nf, *st)
    r1, s1 = t1.full_chunk(counts, nf, *st)
    _, js = je.full_chunk(jstats.put_cell_sharded(counts, je.mesh), nf, ml, mr, nb)
    np.testing.assert_array_equal(tstats.to_host(ts), np_(s1))
    np.testing.assert_array_equal(tstats.to_host(ts), jstats.to_host(js))
    np.testing.assert_allclose(tstats.to_host(tr), np_(r1), **tol)
    # subcluster chunks: group sums over the shards, then the group Viterbi
    labels = (np.arange(64) >= 32).astype(int) * 2 + (np.arange(64) % 2)
    onehot = np.zeros((4, 64), np.float32)
    onehot[labels, np.arange(64)] = 1
    tacc = acc1 = jacc = None
    for half in (slice(0, 32), slice(32, 64)):
        oh = np.ascontiguousarray(onehot[:, half])
        _, *tacc = te.subcluster_chunk(counts[half], nf, *st, oh, acc=tacc)
        _, *acc1 = t1.subcluster_chunk(counts[half], nf, *st, oh, acc=acc1)
        _, *jacc = je.subcluster_chunk(
            jstats.put_cell_sharded(counts[half], je.mesh), nf, ml, mr, nb,
            jstats.put_cell_sharded(oh.T, je.mesh).T, acc=jacc)
    np.testing.assert_allclose(np_(tacc[0]), np_(acc1[0]), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np_(tacc[0]), np_(jacc[0]), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np_(tacc[1]), np_(jacc[1]))
    gm = np_(jacc[0]) / np_(jacc[1])[:, None]
    np.testing.assert_array_equal(np_(te.viterbi_group_means(gm)),
                                  np_(je.viterbi_group_means(gm)))
    with pytest.raises(ValueError, match="not both"):
        CnvEngine(tgo, th, mesh=make_cell_mesh(2, device="cpu"), device="cpu")


@pytest.mark.parametrize("n_shards", [3, 8])
def test_viterbi_per_group_mesh_pads_rows(n_shards):
    """B = 11 rows: padded with ones to the shard count, then dropped."""
    lens = [40, 60, 1, 50]
    jgo, tgo = gene_orders(lens)
    jp_, tp_ = hmms()
    rng = np.random.default_rng(n_shards)
    x = rng.normal(1.0, 0.15, (11, sum(lens))).astype(np.float32)
    x[2, 10:40] -= 0.5
    x[7, 60:100] += 0.7
    sds = np.abs(rng.normal(0.25, 0.05, (11, 6)))
    got = thmm.viterbi_per_group(x, tgo, tp_, sds,
                                 mesh=make_cell_mesh(n_shards, device="cpu"))
    assert got.shape == (11, sum(lens)) and got.dtype == np.int32
    np.testing.assert_array_equal(got, thmm.viterbi_per_group(x, tgo, tp_, sds, device="cpu"))
    np.testing.assert_array_equal(
        got, np.asarray(jhmm.viterbi_per_group(x, jgo, jp_, sds, mesh=jax_mesh(n_shards))))
    with pytest.raises(ValueError, match="mesh"):
        thmm.viterbi_per_group(x, tgo, tp_, mesh=make_cell_mesh(2, device="cpu"),
                               device="cpu")


def _port_run(obj, out, **kw):
    return tp.run(infercnv_from_numpy(vars(obj)), out_dir=str(out), device="cpu", **kw)


@pytest.mark.parametrize("analysis_mode", ["subclusters", "cells"])
def test_run_mesh_matches(tmp_path, analysis_mode):
    """run(n_devices=8) against the port's one-device run (states equal,
    expr within 1e-5) and against the JAX package's run(n_devices=8).  In
    subcluster mode the states equal the reference's; in cell mode the
    residuals differ by float32 rounding (~1e-6), which moves one state
    boundary of one cell of this object (a near-tie of the Viterbi on a
    single cell's row, the same in the port's one-device run), so there
    the step-17 Viterbi is held exactly on the reference's own step-16
    matrix, over the same 8-shard meshes."""
    kw = dict(KW, analysis_mode=analysis_mode)
    r8 = _port_run(_toy_obj(), tmp_path / "t8", n_devices=8, **kw)
    r1 = _port_run(_toy_obj(), tmp_path / "t1", **kw)
    j8 = jp.run(_toy_obj(), out_dir=str(tmp_path / "j8"), n_devices=8, **kw)
    np.testing.assert_array_equal(r8.hmm_states, r1.hmm_states)
    np.testing.assert_allclose(r8.infercnv_obj.expr, r1.infercnv_obj.expr, rtol=0, atol=1e-5)
    np.testing.assert_allclose(r8.infercnv_obj.expr, j8.infercnv_obj.expr, rtol=0, atol=1e-5)
    if analysis_mode == "subclusters":
        np.testing.assert_array_equal(r8.hmm_states, j8.hmm_states)
    else:
        j16 = jp.run(_toy_obj(), out_dir=str(tmp_path / "j16"), n_devices=8,
                     up_to_step=16, **kw).infercnv_obj
        params = jhmm.HMMParams(means=np.array([0.01, 0.5, 1, 1.5, 2, 3]),
                                sds=np.full(6, 0.15), t=1e-6)
        tparams = thmm.HMMParams(means=params.means, sds=params.sds, t=1e-6)
        np.testing.assert_array_equal(
            thmm.predict_hmm_on_cells(infercnv_from_numpy(vars(j16)), tparams,
                                      mesh=make_cell_mesh(8, device="cpu")),
            jhmm.predict_hmm_on_cells(j16, params, mesh=jax_mesh(8)))
        assert (r8.hmm_states != j8.hmm_states).mean() < 1e-3
    st = r8.hmm_states
    tum = r8.infercnv_obj.all_obs_idx()
    G3 = r8.infercnv_obj.num_genes // 3
    assert (st[np.ix_(tum, np.arange(G3, 2 * G3))] < 3).mean() > 0.5
    assert (st[np.ix_(tum, np.arange(2 * G3, 3 * G3))] > 3).mean() > 0.5


def test_run_mesh_uneven_cells(tmp_path):
    """60 cells on 8 shards: the tail chunk pads with ones and the depth
    factor falls back to the host median; the same results as one device."""
    kw = dict(KW, analysis_mode="cells")
    r8 = _port_run(_toy_obj(num_cells=60), tmp_path / "t8", n_devices=8, **kw)
    r1 = _port_run(_toy_obj(num_cells=60), tmp_path / "t1", **kw)
    np.testing.assert_array_equal(r8.hmm_states, r1.hmm_states)
    np.testing.assert_allclose(r8.infercnv_obj.expr, r1.infercnv_obj.expr, rtol=0, atol=1e-5)


def test_run_mesh_multichunk_streaming_equals_single_chunk(tmp_path):
    """Four chunks of 48 cells (a ragged tail of 32) over the 8 shards give
    the results of one chunk, as in the reference."""
    obj = _toy_obj(num_cells=176)
    r_stream = _port_run(obj, tmp_path / "stream", n_devices=8, engine_chunk_cells=48, **KW)
    r_whole = _port_run(obj, tmp_path / "whole", n_devices=8, **KW)
    np.testing.assert_array_equal(r_stream.infercnv_obj.expr, r_whole.infercnv_obj.expr)
    np.testing.assert_array_equal(r_stream.hmm_states, r_whole.hmm_states)
