"""The port's InferCNV object and loaders against the JAX package's, on files
each test writes (tsv, gzipped tsv, 10x mtx, h5ad, CellRanger h5) from a
seeded numpy matrix.  Objects must be array-equal: expr, counts, the gene
order, cell names, groups and the counts md5 in options."""

import gzip
import os

import numpy as np
import pytest

from infercnv_tpu.core import genome as jgenome
from infercnv_tpu.core.object import create_infercnv_object as j_create
from infercnv_tpu.io import loaders as jl
from infercnv_tpu_torch.core import genome as tgenome
from infercnv_tpu_torch.core.object import create_infercnv_object as t_create
from infercnv_tpu_torch.interop import infercnv_from_numpy
from infercnv_tpu_torch.io import loaders as tl

REF_DIR = "/root/reference"


def _tables(seed=5, G=90, C=24):
    """Counts [G, C], gene names (some unmatched in the order table, some on
    chrX, one at start + stop == 0), cell names, annotations, order table."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(rng.gamma(2.0, 20.0, G)[:, None] * np.ones((1, C))).astype(np.float64)
    counts[:, 3] = 0.5          # a cell under the 100-count floor
    genes = [f"G{i}" for i in range(G)]
    cells = [f"cell{j}" for j in range(C)]
    chroms = ["chr1", "chr2", "chrX", "chr3"]
    table = {}
    for i in range(G - 4):           # the last 4 genes have no order entry
        start = int(rng.integers(1, 10_000_000))
        table[genes[i]] = (chroms[i % 4], start, start + 500)
    table[genes[0]] = ("chr1", 0, 0)
    ann = {c: ("normal" if j < 8 else f"tum{j % 3}") for j, c in enumerate(cells[:-2])}
    return counts, genes, cells, ann, table, ["chr1", "chr2", "chrX", "chr3"]


def _assert_objects_equal(t, j):
    np.testing.assert_array_equal(t.expr, j.expr)
    np.testing.assert_array_equal(t.counts, j.counts)
    assert t.expr.dtype == j.expr.dtype and t.counts.dtype == j.counts.dtype
    for f in ("names", "chr_names"):
        assert getattr(t.gene_order, f) == getattr(j.gene_order, f)
    for f in ("chr_ids", "start", "stop"):
        np.testing.assert_array_equal(getattr(t.gene_order, f), getattr(j.gene_order, f))
    assert t.cell_names == j.cell_names
    for a, b in ((t.ref_groups, j.ref_groups), (t.obs_groups, j.obs_groups)):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert t.options == j.options


def _write_inputs(d, counts, genes, cells, ann, table, corner=True, gz=False):
    path = os.path.join(d, "counts.tsv" + (".gz" if gz else ""))
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        f.write(("gene\t" if corner else "") + "\t".join(f'"{c}"' for c in cells) + "\n")
        for g, row in zip(genes, counts):
            f.write(g + "\t" + "\t".join(repr(float(v)) for v in row) + "\n")
    go = os.path.join(d, "order.txt")
    with open(go, "w") as f:
        for g, (c, s, e) in table.items():
            f.write(f"{g}\t{c}\t{s}\t{e}\n")
    an = os.path.join(d, "ann.txt")
    with open(an, "w") as f:
        for c, grp in ann.items():
            f.write(f"{c}\t{grp}\n")
    return path, go, an


@pytest.mark.parametrize("corner,gz", [(True, False), (False, True)])
def test_load_infercnv_object_text(tmp_path, corner, gz):
    tabs = _tables()
    paths = _write_inputs(str(tmp_path), *tabs[:5], corner=corner, gz=gz)
    for fn in ("read_counts_matrix",):
        (tm, tg, tc), (jm, jg, jc) = (getattr(m, fn)(paths[0]) for m in (tl, jl))
        np.testing.assert_array_equal(tm, jm)
        assert (tg, tc) == (jg, jc)
    assert tl.read_gene_order_file(paths[1]) == jl.read_gene_order_file(paths[1])
    assert tl.read_annotations_file(paths[2]) == jl.read_annotations_file(paths[2])
    kw = dict(ref_group_names=["normal"], max_cells_per_group=5)
    t = tl.load_infercnv_object(*paths, **kw)
    j = jl.load_infercnv_object(*paths, **kw)
    _assert_objects_equal(t, j)
    assert t.num_cells < len(tabs[2])   # the filters dropped cells


def test_read_mtx(tmp_path):
    counts, genes, cells, *_ = _tables()
    d = str(tmp_path)
    with open(os.path.join(d, "features.tsv"), "w") as f:
        for i, g in enumerate(genes):
            f.write(f"ENSG{i}\t{g}\tGene Expression\n")
    with open(os.path.join(d, "barcodes.tsv"), "w") as f:
        f.write("\n".join(cells) + "\n")
    nz = np.argwhere(counts > 0)
    with gzip.open(os.path.join(d, "matrix.mtx.gz"), "wt") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{counts.shape[0]} {counts.shape[1]} {len(nz)}\n")
        for i, j in nz:
            f.write(f"{i + 1} {j + 1} {float(counts[i, j])!r}\n")
        f.write("\n")
    args = [os.path.join(d, n) for n in ("matrix.mtx.gz", "features.tsv", "barcodes.tsv")]
    (tm, tg, tc), (jm, jg, jc) = tl.read_mtx(*args), jl.read_mtx(*args)
    np.testing.assert_array_equal(tm, jm)
    assert (tg, tc) == (jg, jc) and tg == genes


def test_read_h5ad_and_10x_h5(tmp_path):
    h5py = pytest.importorskip("h5py")
    counts, genes, cells, *_ = _tables()
    p = str(tmp_path / "x.h5ad")
    with h5py.File(p, "w") as f:
        f["X"] = counts.T
        for grp, names in (("obs", cells), ("var", genes)):
            g = f.create_group(grp)
            g.attrs["_index"] = "_index"
            g["_index"] = np.array(names, dtype="S")
    q = str(tmp_path / "x.h5")
    import scipy.sparse as sp

    m = sp.csc_matrix(counts)
    with h5py.File(q, "w") as f:
        g = f.create_group("matrix")
        g["shape"] = np.array(counts.shape)
        g["data"], g["indices"], g["indptr"] = m.data, m.indices, m.indptr
        g.create_group("features")["name"] = np.array(genes, dtype="S")
        g["barcodes"] = np.array(cells, dtype="S")
    for path in (p, q):
        (tm, tg, tc), (jm, jg, jc) = tl.read_counts_matrix(path), jl.read_counts_matrix(path)
        np.testing.assert_array_equal(tm, jm)
        assert (tg, tc) == (jg, jc) == (genes, cells)


def test_create_object_remove_genes_and_copies():
    counts, genes, cells, ann, table, chrs = _tables(seed=9)
    kw = dict(ref_group_names=["normal"], chr_exclude=("chrX",))
    t = t_create(counts, genes, cells, ann, table, chrs, **kw)
    j = j_create(counts, genes, cells, ann, table, chrs, **kw)
    _assert_objects_equal(t, j)
    assert len(t.options["counts_md5"]) == 32
    drop = np.array([0, 5, 6, t.num_genes - 1])
    _assert_objects_equal(t.remove_genes(drop), j.remove_genes(drop))
    for c in (t.copy(), t.shallow_copy()):
        _assert_objects_equal(c, j)
    assert t.shallow_copy().expr is t.expr and t.copy().expr is not t.expr
    _assert_objects_equal(infercnv_from_numpy(vars(j)), j)


@pytest.mark.parametrize("bad", ["annotation", "ref_group"])
def test_create_object_refuses_bad_inputs(bad):
    counts, genes, cells, ann, table, chrs = _tables()
    ann = dict(ann)
    refs = ["normal"]
    if bad == "annotation":
        ann["not_a_cell"] = "normal"
    else:
        refs = ["no_such_group"]
    for create in (t_create, j_create):
        with pytest.raises(ValueError):
            create(counts, genes, cells, ann, table, chrs, ref_group_names=refs)


def test_order_reduce_matches():
    counts, genes, _cells, _ann, table, chrs = _tables(seed=2)
    te, tgo, trows = tgenome.order_reduce(counts, genes, table, chrs)
    je, jgo, jrows = jgenome.order_reduce(counts, genes, table, chrs)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(trows, jrows)
    assert tgo.names == jgo.names and tgo.chr_names == jgo.chr_names
    np.testing.assert_array_equal(tgo.chr_ids, jgo.chr_ids)
    with pytest.raises(ValueError):
        tgenome.order_reduce(counts, genes, {}, chrs)


def test_rds_inputs_wait_for_the_rds_reader(tmp_path, monkeypatch):
    """.rds counts (once refused, now read by the port's io/rds.py) read as
    the JAX package reads them; the .rda example, with its directory
    absent, fails alike."""
    from infercnv_tpu.io.rds import write_rds_matrix

    counts, genes, cells, *_ = _tables()
    path = str(tmp_path / "counts.rds")
    write_rds_matrix(path, counts, rownames=genes, colnames=cells)
    tm, tg, tc = tl.read_counts_matrix(path)
    jm, jg, jc = jl.read_counts_matrix(path)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tm, counts)
    assert list(tg) == list(jg) == genes and list(tc) == list(jc) == cells
    monkeypatch.setenv("INFERCNV_REFERENCE_DIR", str(tmp_path / "absent"))
    for loader in (tl, jl):
        with pytest.raises(FileNotFoundError):
            loader.load_r_golden_example()


def test_load_bundled_example_matches():
    if not os.path.isdir(REF_DIR):
        pytest.skip(f"{REF_DIR} (the reference's bundled example) is absent")
    _assert_objects_equal(tl.load_bundled_example(), jl.load_bundled_example())
