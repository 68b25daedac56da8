"""The port's Leiden (infercnv_tpu_torch/native, subcluster/leiden.py)
against the JAX package's.

The native Leiden is the reference's C++ built with the same g++ flags, so
its membership arrays equal the JAX package's native ones, seed for seed,
for both objectives.  The kNN and SNN graphs and the auto resolution are
the reference's numpy, so they are equal; the pure-Python ``leiden_plain``
agrees with the native result in structure, as tests/test_leiden.py:42-54
holds the reference's pair.  A failed build raises."""

import importlib

import numpy as np
import pytest
from scipy import sparse

from infercnv_tpu.native import get_leiden_lib as j_get_lib
from infercnv_tpu.subcluster.leiden import auto_resolution as j_auto
from infercnv_tpu.subcluster.leiden import knn_graph as j_knn_graph
from infercnv_tpu.subcluster.leiden import leiden as j_leiden
from infercnv_tpu.subcluster.leiden import snn_graph as j_snn_graph
import infercnv_tpu_torch.native as tnative

from test_leiden import _agreement, planted_graph
from test_leiden_fidelity import _clique_block, _partition_sets
from torch_port_util import one_thread_a_pool

# the module: the sub-package's own `leiden` is the function it exports, as
# in the JAX package (infercnv_tpu/subcluster/__init__.py)
tl = importlib.import_module("infercnv_tpu_torch.subcluster.leiden")


@pytest.fixture(autouse=True)
def _one_thread_a_pool():
    with one_thread_a_pool():
        yield


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native library must be the one compared against,
    not its Python fallback."""
    if j_get_lib() is None:
        pytest.fail("the JAX package's native Leiden did not build")


@pytest.mark.parametrize("objective,res", [("CPM", 0.05), ("CPM", 0.2),
                                           ("modularity", 1.0), ("modularity", 0.5)])
@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_native_membership_equals_the_reference(objective, res, seed):
    rng = np.random.default_rng(seed + 1)
    A, labels = planted_graph(rng, sizes=(40, 35, 25, 12), p_in=0.35, p_out=0.03)
    got = tl.leiden(A, res, objective=objective, seed=seed)
    want = j_leiden(A, res, objective=objective, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64


@pytest.mark.parametrize("seed", [1, 5])
def test_native_membership_on_snn_graphs(seed):
    """Weighted SNN graphs from random neighbour lists, both objectives."""
    rng = np.random.default_rng(seed)
    n, k = 300, 15
    nn = np.stack([np.r_[i, rng.choice(np.delete(np.arange(n), i), k - 1, replace=False)]
                   for i in range(n)])
    A = tl.snn_graph(nn, n)
    for objective, res in (("CPM", tl.auto_resolution(n)), ("modularity", 1.0)):
        np.testing.assert_array_equal(tl.leiden(A, res, objective, seed),
                                      j_leiden(A, res, objective, seed))


def test_fidelity_oracles():
    """tests/test_leiden_fidelity.py's oracles on the port: disjoint
    cliques, both sides of the bridge threshold, disconnected components."""
    sizes = [12, 7, 5, 3]
    A = _clique_block(sizes)
    expected, off = [], 0
    for s in sizes:
        expected.append(frozenset(range(off, off + s)))
        off += s
    for gamma in (0.9, 0.25, 0.01):
        memb = tl.leiden(A, gamma, objective="CPM", seed=0)
        assert _partition_sets(memb) == sorted(expected, key=min), gamma
    A = _clique_block([10, 10], bridges=[(0, 10), (1, 11), (2, 12)])
    assert len(set(tl.leiden(A, 0.05, objective="CPM", seed=0))) == 2
    A = _clique_block([10, 10], bridges=[(i, 10 + i) for i in range(8)])
    assert len(set(tl.leiden(A, 0.05, objective="CPM", seed=0))) == 1
    rng = np.random.default_rng(0)
    blocks, comp = [], []
    for ci, s in enumerate((30, 20, 15)):
        B = np.triu((rng.random((s, s)) < 0.4).astype(float), 1)
        B = B + B.T
        for i in range(s - 1):
            B[i, i + 1] = B[i + 1, i] = 1.0
        blocks.append(B)
        comp += [ci] * s
    A = sparse.csr_matrix(sparse.block_diag(blocks))
    memb = tl.leiden(A, tl.auto_resolution(A.shape[0]), objective="CPM", seed=1)
    comp = np.array(comp)
    for m in set(memb.tolist()):
        assert len(set(comp[memb == m])) == 1


@pytest.mark.parametrize("objective,res", [("CPM", 0.05), ("modularity", 1.0)])
def test_plain_agrees_with_native_in_structure(objective, res):
    rng = np.random.default_rng(42)
    A, labels = planted_graph(rng)
    native = tl.leiden(A, res, objective=objective, seed=7)
    plain = tl.leiden_plain(A, res, objective=objective, seed=7)
    assert _agreement(native, plain) > 0.95
    assert _agreement(plain, labels) > 0.95


@pytest.mark.parametrize("mode", ["undirected", "min"])
def test_graphs_and_resolution_equal(mode):
    rng = np.random.default_rng(3)
    n, k = 60, 8
    nn = np.stack([np.r_[i, rng.choice(np.delete(np.arange(n), i), k - 1, replace=False)]
                   for i in range(n)])
    for got, want in ((tl.knn_graph(nn, n, mode), j_knn_graph(nn, n, mode)),
                      (tl.snn_graph(nn, n), j_snn_graph(nn, n))):
        got, want = got.tocsr(), want.tocsr()
        for a in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
    for c in (3, 100, 32768):
        assert tl.auto_resolution(c) == j_auto(c)
    with pytest.raises(ValueError):
        tl.knn_graph(nn, n + 1)


def test_empty_and_edgeless_graphs():
    np.testing.assert_array_equal(tl.leiden(sparse.csr_matrix((0, 0)), 0.1), [])
    np.testing.assert_array_equal(tl.leiden(sparse.csr_matrix((5, 5)), 0.1),
                                  np.zeros(5, np.int64))


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails (or is missing) raises naming g++; there is no
    fallback and no switch."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "GXX_FLAGS", tnative.GXX_FLAGS + ["-DNO_SUCH=1", "-x", "c++",
                                                                   "-include", "missing.h"])
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tl.leiden(_clique_block([3, 3]), 0.1)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tnative.build()
    assert not (tmp_path / "build" / tnative.LIB_NAME).exists()


def test_build_is_cached_by_digest(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    lib = tnative.build()
    assert lib == tmp_path / "libleiden.so" and lib.exists()
    stamp = (tmp_path / "libleiden.sha256").read_text()
    assert stamp == tnative.source_digest()
    mtime = lib.stat().st_mtime_ns
    assert tnative.build() == lib and lib.stat().st_mtime_ns == mtime


def test_library_goes_to_the_build_directory():
    root = tnative.SOURCE.parents[2]
    assert tnative.BUILD_DIR == root / "build" / "infercnv_tpu_torch"
    assert tnative.get_leiden_lib()._name == str(tnative.BUILD_DIR / tnative.LIB_NAME)
    assert not (tnative.SOURCE.parent / tnative.LIB_NAME).exists()
