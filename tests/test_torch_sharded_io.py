"""The port's per-process cell slices (io/sharded.py) against the JAX
package's: host_cell_slice, and load_counts_shard on .npy, .h5ad (dense,
CSR and CSC) and 10x .h5 files, equal for every host of 8; and
global_cell_array placing this process's rows on its shards."""

import numpy as np
import pytest
import torch

from infercnv_tpu.io import sharded as jsh
from infercnv_tpu_torch.io import sharded as tsh
from infercnv_tpu_torch.parallel.stats import CellMesh, to_host

from test_sharded_io import _write_h5ad


def _same_shards(path, n_hosts=8, **kw):
    for h in range(n_hosts):
        t = tsh.load_counts_shard(path, h, n_hosts, **kw)
        j = jsh.load_counts_shard(path, h, n_hosts, **kw)
        np.testing.assert_array_equal(t[0], j[0])
        assert t[0].dtype == np.float32
        assert t[1:] == j[1:]


def test_host_cell_slice_matches():
    for n in (0, 1, 7, 53, 1000):
        for hosts in (1, 3, 8):
            assert [tsh.host_cell_slice(n, h, hosts) for h in range(hosts)] == \
                [jsh.host_cell_slice(n, h, hosts) for h in range(hosts)]
    with pytest.raises(ValueError, match="host_id"):
        tsh.host_cell_slice(10, 3, 3)


@pytest.mark.parametrize("fmt", ["dense", "csr", "csc"])
def test_load_counts_shard_h5ad_matches(tmp_path, fmt):
    rng = np.random.default_rng(0)
    x = ((rng.random((53, 17)) < 0.3) * rng.integers(1, 9, (53, 17))).astype(np.float32)
    path = str(tmp_path / "m.h5ad")
    _write_h5ad(path, x, fmt)
    _same_shards(path)


def test_load_counts_shard_npy_and_10x_match(tmp_path):
    import h5py
    import scipy.sparse as sp

    rng = np.random.default_rng(4)
    x = rng.poisson(3.0, (41, 25)).astype(np.float32)
    np.save(tmp_path / "c.npy", x)
    _same_shards(str(tmp_path / "c.npy"))
    m = sp.csc_matrix(x.T)
    path = str(tmp_path / "cellranger.h5")
    with h5py.File(path, "w") as f:
        g = f.create_group("matrix")
        for k in ("data", "indices", "indptr"):
            g.create_dataset(k, data=getattr(m, k))
        g.create_dataset("shape", data=np.array(x.T.shape))
        g.create_dataset("barcodes", data=np.array([f"bc{i}".encode() for i in range(41)]))
        g.create_group("features").create_dataset(
            "name", data=np.array([f"g{i}".encode() for i in range(25)]))
    _same_shards(path)
    with pytest.raises(ValueError, match="layer"):
        tsh.load_counts_shard(path, 0, 2, layer="spliced")
    with pytest.raises(ValueError, match="npy"):
        tsh.load_counts_shard(str(tmp_path / "c.tsv"), 0, 1)
    # without a process group: host 0 of 1
    t = tsh.load_counts_shard(str(tmp_path / "c.npy"))
    np.testing.assert_array_equal(t[0], x)
    assert t[3] == (0, 41)


def test_global_cell_array():
    mesh = CellMesh(["cpu"] * 4)
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    sh = tsh.global_cell_array(x, mesh, 20)
    assert len(sh.shards) == 4 and all(s.shape == (5, 2) for s in sh.shards)
    assert all(isinstance(s, torch.Tensor) for s in sh.shards)
    np.testing.assert_array_equal(to_host(sh), x)
    with pytest.raises(ValueError, match="rows"):
        tsh.global_cell_array(x[:16], mesh, 20)
