"""Step 15's Leiden, per-chromosome and random_trees partitions and the
per-chromosome HMM: the port (device="cpu") against the JAX package on the
same numpy inputs, with the reference's range-finder draw handed across.

Equal: the subclusters of ``define_tumor_subclusters`` with Leiden (PCA and
simple, CPM and modularity, auto and fixed resolution, from host rows and
from device chunks, with a group above LINKAGE_MAX_CELLS), the
per-chromosome subclusters, the random_trees partitions,
``split_references`` and the states of ``predict_hmm_on_subclusters_per_chr``
and of ``viterbi_per_group(impl="perchr")``.  The stored dendrograms are
equal where both packages build them from host rows in float64, and agree
within float32 rounding where they come from the device's subcluster mean
profiles.  ``runmean_median_center`` within 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infercnv_tpu.core.object import InferCNV as JObj
from infercnv_tpu.models import hmm as jhmm
from infercnv_tpu.subcluster import partition as jpart
from infercnv_tpu_torch.interop import infercnv_from_numpy
from infercnv_tpu_torch.models import hmm as thmm
from infercnv_tpu_torch.subcluster import partition as tpart
from infercnv_tpu_torch.subcluster import pca as tpca

from test_torch_pca_knn import jax_omega
from torch_port_util import MEANS, SDS, gene_orders, hmms, one_thread_a_pool


@pytest.fixture(autouse=True)
def _one_thread_a_pool():
    with one_thread_a_pool():
        yield


@pytest.fixture(autouse=True)
def handed_omega(monkeypatch):
    monkeypatch.setattr(tpca, "range_omega", jax_omega)


def _object(seed=11, lens=(60, 50, 70), wide=0, hspike=True):
    """Residual-like values around 1: two observation groups of planted
    clones with their own CNV segments (75 and 50 cells), a reference
    group of 40 with a few genes of large spread.  wide > 0 appends that
    many genes on a fourth chromosome (so the VST selection runs), each
    with its own spread, so that the selection has no near-ties at its
    cutoff: on genes of one spread the float32 gene moments decide it, and
    the reference's own host (float64) and device (float32) routes pick
    feature sets that differ by a few genes there."""
    rng = np.random.default_rng(seed)
    lens = list(lens) + ([wide] if wide else [])
    jgo, _ = gene_orders(lens)
    G = sum(lens)
    blocks, obs, c0 = [], {}, 0
    for g, sizes in (("tumA", (30, 25, 20)), ("tumB", (28, 22))):
        idx = []
        for k, n in enumerate(sizes):
            prof = np.ones(G, np.float32)
            lo = 15 * k + (7 if g == "tumB" else 0)
            prof[lo:lo + 30] += 0.45 * (k + 1) * (-1) ** k
            prof[70 + 20 * k:100 + 20 * k] -= 0.25
            blocks.append(prof + rng.normal(0, 0.04, (n, G)).astype(np.float32))
            idx.extend(range(c0, c0 + n))
            c0 += n
        obs[g] = np.array(idx)
    ref = rng.normal(1.0, 0.04, (40, G)).astype(np.float32)
    ref[:, :3] += rng.normal(0, 1.0, (40, 3)).astype(np.float32)
    blocks.append(ref)
    expr = np.concatenate(blocks)
    C = expr.shape[0]
    if wide:
        spread = np.linspace(0.02, 0.06, wide, dtype=np.float32)
        expr[:, -wide:] = 1.0 + rng.normal(0, 1, (C, wide)).astype(np.float32) * spread
    hs = _object(seed + 1, lens=(20, 20, 20), hspike=False) if hspike else None
    return JObj(expr=expr, counts=expr.copy(), gene_order=jgo,
                cell_names=[f"c{i}" for i in range(C)],
                ref_groups={"normal": np.arange(c0, C)}, obs_groups=obs,
                hspike=hs)


def _chunks(expr, rows=64):
    jc = [(b, min(rows, expr.shape[0] - b), jnp.asarray(expr[b:b + rows]))
          for b in range(0, expr.shape[0], rows)]
    tc = [(b, n, torch.from_numpy(expr[b:b + rows].copy())) for b, n, _ in jc]
    return jc, tc


def _assert_subclusters(t, j, exact_hc=True):
    assert list(t["subclusters"]) == list(j["subclusters"])
    for g, subs in j["subclusters"].items():
        assert list(t["subclusters"][g]) == list(subs), g
        for name, idx in subs.items():
            np.testing.assert_array_equal(t["subclusters"][g][name], idx)
        if j["hc"][g] is None:
            assert t["hc"][g] is None
        elif exact_hc:
            np.testing.assert_array_equal(t["hc"][g], j["hc"][g])
        else:
            np.testing.assert_allclose(t["hc"][g], j["hc"][g], rtol=1e-5, atol=1e-6)


LEIDEN_CASES = [
    dict(leiden_method="PCA", leiden_function="CPM", leiden_resolution="auto"),
    dict(leiden_method="PCA", leiden_function="modularity", leiden_resolution=1.0),
    dict(leiden_method="simple", leiden_function="CPM", leiden_resolution=0.05),
    dict(leiden_method="simple", leiden_function="modularity", leiden_resolution="auto"),
]


@pytest.mark.parametrize("case", LEIDEN_CASES,
                         ids=lambda c: f"{c['leiden_method']}-{c['leiden_function']}"
                                       f"-{c['leiden_resolution']}")
@pytest.mark.parametrize("rows", ["host", "device_chunks"])
def test_leiden_partitions_equal(case, rows):
    j = _object()
    t = infercnv_from_numpy(vars(j))
    kw = dict(partition_method="leiden", k_nn=10, **case)
    if rows == "device_chunks":
        jc, tc = _chunks(j.expr)
        kw_j, kw_t = dict(kw, device_chunks=jc), dict(kw, device_chunks=tc)
    else:
        kw_j = kw_t = kw
    assert jpart.define_tumor_subclusters(j, **kw_j) is None
    assert tpart.define_tumor_subclusters(t, device="cpu", **kw_t) is None
    _assert_subclusters(t.tumor_subclusters, j.tumor_subclusters)
    _assert_subclusters(t.hspike.tumor_subclusters, j.hspike.tumor_subclusters)
    assert tpart.ROWS_FROM == rows
    assert {"knn", "snn", "leiden", "linkage"} <= set(tpart.PHASE_TIMES)
    # the planted clones are found and never mixed
    subs = t.tumor_subclusters["subclusters"]["tumA"]
    assert len(subs) >= 2
    clone = np.repeat([0, 1, 2], (30, 25, 20))
    for idx in subs.values():
        assert len(set(clone[np.asarray(idx)])) == 1


@pytest.mark.parametrize("rows", ["host", "device_chunks"])
def test_leiden_whole_observation_group_with_vst_and_large_group_linkage(monkeypatch, rows):
    """cluster_by_groups=False with 2,000 genes appended, so the VST
    selection runs, and LINKAGE_MAX_CELLS below the group's 125 cells, so
    its dendrogram is built on the subcluster mean profiles (host numpy
    means from host rows, a product on the device from device chunks)."""
    for mod in (jpart, tpart):
        monkeypatch.setattr(mod, "LINKAGE_MAX_CELLS", 100)
    j = _object(seed=5, wide=2000, hspike=False)
    t = infercnv_from_numpy(vars(j))
    kw = dict(partition_method="leiden", cluster_by_groups=False, k_nn=15)
    if rows == "device_chunks":
        jc, tc = _chunks(j.expr, rows=50)
        jpart.define_tumor_subclusters(j, device_chunks=jc, **kw)
        tpart.define_tumor_subclusters(t, device="cpu", device_chunks=tc, **kw)
    else:
        jpart.define_tumor_subclusters(j, **kw)
        tpart.define_tumor_subclusters(t, device="cpu", **kw)
    _assert_subclusters(t.tumor_subclusters, j.tumor_subclusters,
                        exact_hc=rows == "host")
    assert len(t.tumor_subclusters["subclusters"]["all_observations"]) >= 3


def test_small_groups_and_k_above_group_size():
    j = _object(hspike=False)
    j.obs_groups["tiny"] = np.array([0, 1])
    j.obs_groups["tumA"] = j.obs_groups["tumA"][2:]
    t = infercnv_from_numpy(vars(j))
    kw = dict(partition_method="leiden", k_nn=60)
    jpart.define_tumor_subclusters(j, **kw)
    tpart.define_tumor_subclusters(t, device="cpu", **kw)
    _assert_subclusters(t.tumor_subclusters, j.tumor_subclusters)
    assert list(t.tumor_subclusters["subclusters"]["tiny"]) == ["tiny_s1"]
    assert list(t.tumor_subclusters["subclusters"]["tumB"]) == ["tumB"]


@pytest.mark.parametrize("refs", [False, True])
@pytest.mark.parametrize("by_groups", [True, False])
def test_per_chromosome_subclusters_equal(refs, by_groups):
    j = _object(hspike=False)
    t = infercnv_from_numpy(vars(j))
    kw = dict(partition_method="leiden", k_nn=10, per_chr_hmm_subclusters=True,
              per_chr_hmm_subclusters_references=refs, cluster_by_groups=by_groups)
    want = jpart.define_tumor_subclusters(j, **kw)
    got = tpart.define_tumor_subclusters(t, device="cpu", **kw)
    _assert_subclusters(t.tumor_subclusters, j.tumor_subclusters)
    assert list(got) == list(want) == list(t.gene_order.chr_names)
    for c in want:
        assert list(got[c]) == list(want[c]), c
        for name in want[c]:
            np.testing.assert_array_equal(got[c][name], want[c][name])
    assert any(len(v) > 2 for v in got.values())


def test_runmean_median_center():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(7, 130)).astype(np.float32)
    for k in (1, 2, 11, 101, 301):
        np.testing.assert_allclose(tpart.runmean_median_center(x, k),
                                   jpart.runmean_median_center(x, k),
                                   rtol=1e-12, atol=1e-12)
    assert tpart.runmean_median_center(x[:, :0], 11).shape == (7, 0)


def test_random_trees_recursion_exact():
    """The permutation test and its recursion on the same rows and the same
    numpy generator give the same partitions."""
    j = _object(hspike=False)
    idx = np.concatenate([j.obs_groups["tumA"], j.obs_groups["tumB"]])
    x = j.expr[idx]
    for p_val, window in ((0.1, 21), (0.5, 5)):
        want = jpart._random_trees_recurse(idx, x, p_val, np.random.default_rng(3),
                                           window_size=window)
        got = tpart._random_trees_recurse(idx, x, p_val, np.random.default_rng(3),
                                          window_size=window, device="cpu")
        assert len(got) == len(want) and len(got) > 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("by_groups", [True, False])
def test_random_trees_partitions_equal(by_groups):
    j = _object(hspike=False)
    t = infercnv_from_numpy(vars(j))
    kw = dict(partition_method="random_trees", random_trees_window_size=21,
              cluster_by_groups=by_groups, seed=7)
    jpart.define_tumor_subclusters(j, **kw)
    tpart.define_tumor_subclusters(t, device="cpu", **kw)
    _assert_subclusters(t.tumor_subclusters, j.tumor_subclusters, exact_hc=False)
    assert max(len(s) for s in t.tumor_subclusters["subclusters"].values()) > 1


@pytest.mark.parametrize("k,method", [(2, "complete"), (3, "ward.D2"), (2, "average")])
def test_split_references_equal(k, method):
    j = _object(hspike=False)
    t = infercnv_from_numpy(vars(j))
    jpart.split_references(j, k, method)
    tpart.split_references(t, k, method, device="cpu")
    assert list(t.ref_groups) == list(j.ref_groups) == [f"refgrp-{i + 1}" for i in range(k)]
    for name in j.ref_groups:
        np.testing.assert_array_equal(t.ref_groups[name], j.ref_groups[name])
    j.ref_groups, t.ref_groups = {}, {}
    for fn in (lambda: jpart.split_references(j, 2),
               lambda: tpart.split_references(t, 2, device="cpu")):
        with pytest.raises(ValueError, match="no reference cells"):
            fn()


@pytest.mark.parametrize("trend", [False, True])
def test_per_chromosome_hmm_states_equal(trend):
    """The reference's per-chromosome partitions handed to both HMMs."""
    j = _object(hspike=False)
    t = infercnv_from_numpy(vars(j))
    per_chr = jpart.define_tumor_subclusters(
        j, partition_method="leiden", k_nn=10, per_chr_hmm_subclusters=True)
    t.tumor_subclusters = infercnv_from_numpy(vars(j)).tumor_subclusters
    jp, tp = hmms(MEANS, SDS)
    fits = {lv: (0.3, -0.4) for lv in thmm.I6_LEVELS} if trend else None
    want = jhmm.predict_hmm_on_subclusters_per_chr(j, jp, per_chr, fits)
    got = thmm.predict_hmm_on_subclusters_per_chr(t, tp, per_chr, fits, device="cpu")
    assert got.dtype == np.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got != 3).any() and (got == 3).any()


def test_viterbi_perchr_equals_reference_and_packed():
    """Rows of per-group means on a genome with a one-gene chromosome:
    impl='perchr' equals the JAX package's perchr and the port's packed."""
    lens = [50, 1, 33, 70, 2]
    jgo, tgo = gene_orders(lens)
    jp, tp = hmms(MEANS, SDS)
    rng = np.random.default_rng(9)
    G = sum(lens)
    x = rng.normal(1.0, 0.15, (6, G)).astype(np.float32)
    x[1, 10:40] -= 0.5
    x[2, 60:100] += 0.7
    x[4, 120:] -= 0.9
    sds = np.abs(rng.normal(0.25, 0.05, (6, 6)))
    want = jhmm.viterbi_per_group(x, jgo, jp, sds, impl="perchr")
    got = thmm.viterbi_per_group(x, tgo, tp, sds, impl="perchr", device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        got, thmm.viterbi_per_group(x, tgo, tp, sds, device="cpu"))
    assert (got[:, 50] == 3).all() and (got != 3).any()
    with pytest.raises(ValueError, match="impl"):
        thmm.viterbi_per_group(x, tgo, tp, impl="mesh", device="cpu")
