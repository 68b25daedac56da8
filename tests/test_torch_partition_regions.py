"""Step 15's partitions and the region reports: the port (device="cpu")
against the JAX package on the same numpy inputs.

Exact: the z-score gene filter, the float64 distances of groups up to 1,024
cells, the linkages, the hclust, Leiden and random_trees partitions (on
planted data, where Ward's merge order and the kNN have no near ties), and
the bytes of every report file."""

import filecmp
import os

import numpy as np
import pytest

from infercnv_tpu.core.object import InferCNV as JObj
from infercnv_tpu.models.hmm import GroupedStates as JGrouped
from infercnv_tpu.report import regions as jreg
from infercnv_tpu.subcluster import distance as jdist
from infercnv_tpu.subcluster import partition as jpart
from infercnv_tpu_torch.interop import infercnv_from_numpy
from infercnv_tpu_torch.models.hmm import GroupedStates as TGrouped
from infercnv_tpu_torch.report import regions as treg
from infercnv_tpu_torch.subcluster import distance as tdist
from infercnv_tpu_torch.subcluster import partition as tpart

from torch_port_util import gene_orders


def _planted(seed=4, with_hspike=True):
    """Residual-like values around 1 on 3 chromosomes: two observation
    groups, each made of three clones with their own CNV segments, and a
    reference group; a few genes of large reference spread."""
    rng = np.random.default_rng(seed)
    lens = [40, 30, 50]
    jgo, _ = gene_orders(lens)
    G = sum(lens)
    blocks, obs, c0 = [], {}, 0
    for g, sizes in (("tumA", (14, 9, 5)), ("tumB", (11, 11, 4))):
        idx = []
        for k, n in enumerate(sizes):
            prof = np.ones(G, np.float32)
            prof[10 * k:10 * k + 25] += 0.4 * (k + 1) * (-1) ** k
            blocks.append(prof + rng.normal(0, 0.03, (n, G)).astype(np.float32))
            idx.extend(range(c0, c0 + n))
            c0 += n
        obs[g] = np.array(idx)
    ref = rng.normal(1.0, 0.03, (12, G)).astype(np.float32)
    ref[:, :3] += rng.normal(0, 1.0, (12, 3)).astype(np.float32)
    blocks.append(ref)
    expr = np.concatenate(blocks)
    C = expr.shape[0]
    hs = None
    if with_hspike:
        h = _planted(seed + 1, with_hspike=False)
        hs = h
    return JObj(expr=expr, counts=expr.copy(), gene_order=jgo,
                cell_names=[f"c{i}" for i in range(C)],
                ref_groups={"normal": np.arange(c0, C)}, obs_groups=obs,
                hspike=hs)


def test_zscore_filter_and_distances():
    j = _planted()
    t = infercnv_from_numpy(vars(j))
    for z in (0.0, 0.8, 1.5):
        np.testing.assert_array_equal(tpart.zscore_gene_filter(t, z),
                                      jpart.zscore_gene_filter(j, z))
    assert tpart.zscore_gene_filter(t, 0.8).size < t.num_genes
    np.testing.assert_array_equal(tdist.condensed_dists(j.expr),
                                  jdist.condensed_dists(j.expr))
    np.testing.assert_array_equal(tdist.pairwise_dists(j.expr),
                                  jdist.pairwise_dists(j.expr))
    assert tdist.pairwise_sq_dists(j.expr).dtype == np.float64
    # above 1,024 rows (or for a tensor) the product is float32 on the device
    big = np.random.default_rng(0).normal(size=(1030, 8)).astype(np.float32)
    d2 = tdist.pairwise_sq_dists(big, device="cpu")
    np.testing.assert_allclose(d2.numpy(), np.asarray(jdist.pairwise_sq_dists(big)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(tpart.ward_linkage(j.expr), jpart.ward_linkage(j.expr))


def _assert_subclusters_equal(t, j):
    assert list(t["subclusters"]) == list(j["subclusters"])
    for g in j["subclusters"]:
        assert list(t["subclusters"][g]) == list(j["subclusters"][g])
        for name, idx in j["subclusters"][g].items():
            np.testing.assert_array_equal(t["subclusters"][g][name], idx)
        if j["hc"][g] is None:
            assert t["hc"][g] is None
        else:
            np.testing.assert_array_equal(t["hc"][g], j["hc"][g])


@pytest.mark.parametrize("method", ["qnorm", "pheight", "qgamma", "none"])
@pytest.mark.parametrize("by_groups", [True, False])
def test_partitions_equal(method, by_groups):
    j = _planted()
    t = infercnv_from_numpy(vars(j))
    kw = dict(p_val=0.1, partition_method=method, cluster_by_groups=by_groups,
              z_score_filter=0.8)
    jpart.define_tumor_subclusters(j, **kw)
    tpart.define_tumor_subclusters(t, device="cpu", **kw)
    _assert_subclusters_equal(t.tumor_subclusters, j.tumor_subclusters)
    _assert_subclusters_equal(t.hspike.tumor_subclusters, j.hspike.tumor_subclusters)
    if method == "qnorm" and by_groups:
        # the planted clones come out as subclusters
        assert len(t.tumor_subclusters["subclusters"]["tumA"]) >= 2
    assert set(tpart.PHASE_TIMES) == {"z_filter", "gene_filter", "slice"}
    assert tpart.ROWS_FROM == "host"


@pytest.mark.parametrize("method", ["leiden", "random_trees"])
def test_leiden_and_random_trees_partitions_equal(monkeypatch, method):
    """The partitions that were refused until step 15 was ported in full,
    now against the reference on the same planted clones (the reference's
    PCA range-finder draw handed across), with split_references; 'shc'
    stays refused as the reference refuses it."""
    from test_torch_pca_knn import jax_omega
    from infercnv_tpu_torch.subcluster import pca as tpca

    monkeypatch.setattr(tpca, "range_omega", jax_omega)
    j = _planted()
    t = infercnv_from_numpy(vars(j))
    kw = dict(p_val=0.1, partition_method=method, k_nn=8, random_trees_window_size=11)
    jpart.define_tumor_subclusters(j, **kw)
    tpart.define_tumor_subclusters(t, device="cpu", **kw)
    for g, subs in j.tumor_subclusters["subclusters"].items():
        assert list(t.tumor_subclusters["subclusters"][g]) == list(subs)
        for name, idx in subs.items():
            np.testing.assert_array_equal(t.tumor_subclusters["subclusters"][g][name], idx)
    _assert_subclusters_equal(t.hspike.tumor_subclusters, j.hspike.tumor_subclusters)
    assert len(t.tumor_subclusters["subclusters"]["tumA"]) >= 2
    jpart.split_references(j, 2)
    tpart.split_references(t, 2, device="cpu")
    assert list(t.ref_groups) == list(j.ref_groups) == ["refgrp-1", "refgrp-2"]
    for name in j.ref_groups:
        np.testing.assert_array_equal(t.ref_groups[name], j.ref_groups[name])
    with pytest.raises(NotImplementedError):
        tpart.define_tumor_subclusters(t, partition_method="shc", device="cpu")


def _states(obj, seed=0):
    """Segmented 1-based i6 states: per observation clone its own runs."""
    rng = np.random.default_rng(seed)
    C, G = obj.expr.shape
    st = np.full((C, G), 3, np.int8)
    for k, idx in enumerate(obj.obs_groups.values()):
        lo = int(rng.integers(0, G - 30))
        st[np.asarray(idx)[: 6 + k], lo:lo + 20] = 1 + 3 * k
        st[np.asarray(idx)[2:], 70:95] = 5
    st[-1, :2] = 2    # a reference cell with a short loss
    return st


@pytest.mark.parametrize("by", ["subcluster", "consensus", "cell"])
@pytest.mark.parametrize("factorized", [False, True])
def test_region_reports_byte_equal(tmp_path, by, factorized):
    j = _planted(with_hspike=False)
    jpart.define_tumor_subclusters(j, partition_method="qnorm")
    t = infercnv_from_numpy(vars(j))
    st = _states(j)
    if factorized:
        rows, inv = np.unique(st, axis=0, return_inverse=True)
        args = [dict(rows=rows, cell_to_row=inv.astype(np.int32).ravel(),
                     names=[f"r{i}" for i in range(len(rows))])]
        js, ts = JGrouped(**args[0]), TGrouped(**args[0])
        np.testing.assert_array_equal(ts.materialize(), st)
        assert ts.shape == js.shape
    else:
        js = ts = st
    for neutral in (3, None):
        dj, dt = tmp_path / f"j{neutral}", tmp_path / f"t{neutral}"
        rj = jreg.generate_cnv_region_reports(j, js, "17_HMM_pred.x", str(dj), neutral, by)
        rt = treg.generate_cnv_region_reports(t, ts, "17_HMM_pred.x", str(dt), neutral, by)
        files = sorted(os.listdir(dj))
        assert len(files) == 4 and files == sorted(os.listdir(dt))
        for f in files:
            assert filecmp.cmp(dj / f, dt / f, shallow=False), f
        assert [g.group_name for g in rt] == [g.group_name for g in rj]
        assert [len(g.regions) for g in rt] == [len(g.regions) for g in rj]
