"""The port's heatmap data side (infercnv_tpu_torch/viz/heatmap.py,
device="cpu") against the JAX package's viz/heatmap.py on seeded inputs:
the range within float32 rounding (one case above torch.quantile's 2^24
elements), the centre within 1e-6, the PC1 order equal on separated rows,
the panes, the downsampling and the bp-scaled columns within 1e-6, the
key's histogram counts equal, the row orders and linkages equal; and the
port's plot_cnv rendering tests/test_heatmap_golden.py's object against
the committed golden at that test's tolerances."""

import os

import numpy as np
import pytest
import torch

import infercnv_tpu.viz.heatmap as jh
import infercnv_tpu_torch.viz.heatmap as th
from infercnv_tpu_torch.interop import infercnv_from_numpy

from test_heatmap_golden import GOLDEN
from test_pipeline import make_synthetic
from torch_port_util import gene_orders, one_thread_a_pool

F32 = dict(rtol=2.0 ** -23, atol=0)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_a_pool():
        yield


def _values(case: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if case == "one":
        return np.array([1.3], np.float32)
    if case == "two":
        return np.array([0.7, 1.3], np.float32)
    if case == "ties":        # integer values, most of them tied
        return rng.integers(-3, 4, size=(40, 30)).astype(np.float32)
    if case == "negative":
        return rng.normal(-2.0, 3.0, size=(123, 45)).astype(np.float32)
    if case == "centred":     # a quarter of the values at the centre
        x = rng.normal(1.0, 0.2, size=(300, 200)).astype(np.float32)
        x[::4] = 1.0
        return x
    return rng.normal(1.0, 0.2, size=(300, 200)).astype(np.float32)


@pytest.mark.parametrize("case", ["one", "two", "ties", "negative", "centred", "normal"])
@pytest.mark.parametrize("center", ["one", "mean"])
def test_x_range_auto_matches(case, center):
    x = _values(case)
    c = 1.0 if center == "one" else float(np.mean(x))
    want = jh.get_x_range_auto(x, c)
    got = th.get_x_range_auto(x, c, device="cpu")
    np.testing.assert_allclose(got, want, **F32)
    got_t = th.get_x_range_auto(torch.from_numpy(x), c)     # a tensor's own device
    np.testing.assert_allclose(got_t, want, **F32)


def test_x_range_auto_above_torch_quantile_limit():
    """About 2^24 + 4,099 values off the centre: more than torch.quantile
    takes."""
    n = (1 << 24) + 4099
    rng = np.random.default_rng(12)
    x = rng.normal(1.0, 0.3, size=n + 5000).astype(np.float32)
    x[rng.choice(x.size, 5000, replace=False)] = 1.0
    assert (x != 1.0).sum() > 1 << 24
    with pytest.raises(RuntimeError):
        torch.quantile(torch.from_numpy(x[x != 1.0]), 0.01)
    want = jh.get_x_range_auto(x, 1.0)
    got = th.get_x_range_auto(x, 1.0, device="cpu")
    np.testing.assert_allclose(got, want, **F32)


def _objects(seed=7, n_normal=30, n_tumor=30, genes_per_chr=60, subclusters=True):
    """(JAX object, port object): make_synthetic's counts as log values,
    with tumour subclusters of 12, 10 and 8 cells and normal ones of 18
    and 12 when `subclusters`."""
    jo = make_synthetic(seed=seed, n_normal=n_normal, n_tumor=n_tumor,
                        genes_per_chr=genes_per_chr)
    jo.expr = (np.log1p(np.asarray(jo.expr, np.float64)) / 4.0).astype(np.float32)
    if subclusters:
        t = np.asarray(jo.obs_groups["tumor"])
        n = np.asarray(jo.ref_groups["normal"])
        jo.tumor_subclusters = {"subclusters": {
            "tumor": {"tumor_s1": t[:12], "tumor_s2": t[12:22], "tumor_s3": t[22:]},
            "normal": {"normal_s1": n[:18], "normal_s2": n[18:]}}, "hc": {}}
    return jo, infercnv_from_numpy(vars(jo))


def test_x_center_matches():
    """Dense (float32 and float64), a state matrix with a value table, and
    factorized rows, against the JAX package's formulas (:403-411)."""
    jo, to = _objects()
    for expr in (jo.expr, jo.expr.astype(np.float64)):
        to.expr = expr
        d = th.heatmap_data(to, x_range=(0.5, 1.5), device="cpu")
        np.testing.assert_allclose(d.x_center, float(np.mean(expr.astype(np.float32))),
                                   rtol=1e-6)
    rng = np.random.default_rng(3)
    states = rng.integers(1, 7, size=jo.expr.shape).astype(np.int8)
    lut = np.concatenate([[np.nan], np.linspace(0, 3, 6)]).astype(np.float32)
    to.expr = states
    d = th.heatmap_data(to, x_range=(0.0, 3.0), value_lut=lut, device="cpu")
    cnt = np.bincount(states.ravel(), minlength=lut.size)
    np.testing.assert_allclose(
        d.x_center, float(np.nansum(cnt * np.nan_to_num(lut)) / cnt.sum()), rtol=1e-6)
    rows = rng.normal(1, 0.3, size=(5, jo.expr.shape[1])).astype(np.float32)
    c2r = rng.integers(0, 5, size=jo.expr.shape[0]).astype(np.int32)
    to.expr = jo.expr
    d = th.heatmap_data(to, x_range=(0.0, 3.0), row_values=(rows, c2r), device="cpu")
    w = np.bincount(c2r, minlength=5).astype(np.float64)
    np.testing.assert_allclose(d.x_center, float((w @ rows.mean(axis=1)) / w.sum()),
                               rtol=1e-6)


def _separated_rows(n=90, G=40, seed=4):
    """Rows t * u + small noise, t spread out: PC1 projections well apart."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=G)
    t = rng.permutation(np.linspace(-3, 3, n))
    return (t[:, None] * u[None, :] + rng.normal(0, 0.01, (n, G))).astype(np.float32)


def test_pc1_order_matches_on_separated_rows():
    x = _separated_rows()
    np.testing.assert_array_equal(th._pc1_order(x, device="cpu"), jh._pc1_order(x))
    np.testing.assert_array_equal(th._pc1_order(torch.from_numpy(x)), jh._pc1_order(x))
    assert np.array_equal(th._pc1_order(np.zeros((5, 3)), device="cpu"), np.arange(5))


def _pane_case(down: bool):
    rng = np.random.default_rng(5)
    C, G = 400, 60
    expr = rng.normal(1.0, 0.3, size=(C, G)).astype(np.float32)
    idx = rng.permutation(C)[:350]
    sizes = [("a", 200), ("b", 100), ("c", 50)]
    return expr, idx, sizes, (40 if down else 2000)


@pytest.mark.parametrize("down", [False, True])
@pytest.mark.parametrize("lut", [False, True])
def test_pane_matrix_dense_matches(down, lut):
    expr, idx, sizes, cap = _pane_case(down)
    table = None
    if lut:
        expr = np.random.default_rng(6).integers(1, 7, size=expr.shape).astype(np.int8)
        table = np.concatenate([[np.nan], np.linspace(-1, 3, 6)]).astype(np.float32)
    want = jh._pane_matrix_dense(expr, idx, sizes, cap, 0.7, 1.3, table)
    got = th._pane_matrix_dense(expr, idx, sizes, cap, 0.7, 1.3, table, device="cpu")
    assert got[1] == want[1] and got[2] == want[2] == down
    assert got[0].dtype == np.float32 and got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("down", [False, True])
def test_pane_matrix_rows_matches(down):
    _, idx, sizes, cap = _pane_case(down)
    rng = np.random.default_rng(7)
    rows = rng.normal(1.0, 0.5, size=(9, 60)).astype(np.float32)
    c2r = rng.integers(0, 9, size=400).astype(np.int32)
    want = jh._pane_matrix_rows(rows, c2r, idx, sizes, cap, 0.7, 1.3)
    got = th._pane_matrix_rows(rows, c2r, idx, sizes, cap, 0.7, 1.3, device="cpu")
    assert got[1] == want[1] and got[2] == want[2] == down
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)


def test_downsample_rows_matches():
    rng = np.random.default_rng(3)
    mat = rng.standard_normal((1000, 8)).astype(np.float32)
    sizes = [("a", 600), ("b", 300), ("c", 100)]
    want = jh._downsample_rows(mat, sizes, 100)
    got = th._downsample_rows(mat, sizes, 100, device="cpu")
    assert got[1] == want[1] and got[2] and want[2]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    same, same_sizes, down = th._downsample_rows(mat, sizes, 2000, device="cpu")
    assert not down and same is mat and same_sizes == sizes


def test_bp_scale_matrix_matches():
    jgo, tgo = gene_orders([50, 30, 20])
    data = np.random.default_rng(8).normal(size=(7, 100)).astype(np.float32)
    for lengths in (None, [60_000, 40_000, 90_000]):
        mw, bw = jh._bp_scale_matrix(data, jgo, lengths, width=120)
        mg, bg = th._bp_scale_matrix(data, tgo, lengths, width=120)
        assert bg == bw
        np.testing.assert_allclose(mg, mw, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rng_", [(0.6, 1.4), (0.7, 1.3), (-1.0, 3.0), "auto"])
@pytest.mark.parametrize("weighted", [False, True])
def test_histogram_counts_equal(rng_, weighted):
    """The key's histogram: numpy's bin rule on clipped float32 values,
    with per-row weights as the factorized panes give them."""
    x = _values("centred")
    lo, hi = jh.get_x_range_auto(x, 1.0) if rng_ == "auto" else rng_
    w = None
    if weighted:
        w = np.broadcast_to(np.arange(1.0, x.shape[0] + 1)[:, None], x.shape)
    c_want, e_want = np.histogram(np.clip(x, lo, hi), bins=50, range=(lo, hi), weights=w)
    h = th._Histogram(lo, hi)
    h.add(torch.from_numpy(x[:100]), None if w is None else torch.from_numpy(w[:100].copy()))
    h.add(torch.from_numpy(x[100:]), None if w is None else torch.from_numpy(w[100:].copy()))
    c_got, e_got = h.result()
    np.testing.assert_array_equal(c_got, c_want)
    assert e_got.dtype == e_want.dtype
    np.testing.assert_array_equal(e_got, e_want)


def _order_pair(jo, to, group, idx, **kw):
    cj, ct = {}, {}
    oj, zj = jh._group_cell_order(jo, group, idx, True, cj, **kw)
    ot, zt = th._group_cell_order(to, group, idx, True, ct, device="cpu", **kw)
    np.testing.assert_array_equal(ot, oj)
    assert (zt is None) == (zj is None)
    if zj is not None:
        np.testing.assert_allclose(zt, zj, rtol=1e-12, atol=1e-12)
    assert list(ct) == list(cj)          # the row_order_cache keys
    return ot


@pytest.mark.parametrize("method", ["ward.D", "complete", "average"])
def test_group_cell_order_matches(method):
    """Stored subclusters (each ordered by its linkage, merged), a fresh
    linkage, and ref_contig (the named contig's genes, subclusters
    ignored)."""
    jo, to = _objects()
    for g, idx in list(jo.obs_groups.items()) + list(jo.ref_groups.items()):
        _order_pair(jo, to, g, np.asarray(idx), hclust_method=method)
    jo.tumor_subclusters = to.tumor_subclusters = None
    _order_pair(jo, to, "tumor", np.asarray(jo.obs_groups["tumor"]), hclust_method=method)
    jo2, to2 = _objects()
    sel = np.nonzero(jo2.gene_order.chr_ids == 1)[0]
    _order_pair(jo2, to2, "tumor", np.asarray(jo2.obs_groups["tumor"]),
                hclust_method=method, gene_sel=sel, ignore_subclusters=True)


def test_group_cell_order_pc1_above_order_linkage_max(monkeypatch):
    """Blocks above ORDER_LINKAGE_MAX (shrunk to 20) take the PC1 order:
    a subcluster of 40 rows among linkage-ordered ones, and a whole group."""
    monkeypatch.setattr(jh, "ORDER_LINKAGE_MAX", 20)
    monkeypatch.setattr(th, "ORDER_LINKAGE_MAX", 20)
    jo, to = _objects(n_normal=20, n_tumor=60)
    x = _separated_rows(n=80, G=jo.expr.shape[1])
    jo.expr = to.expr = x
    t = np.asarray(jo.obs_groups["tumor"])
    subs = {"tumor": {"big": t[:40], "mid": t[40:52], "small": t[52:]}}
    jo.tumor_subclusters = {"subclusters": subs, "hc": {}}
    to.tumor_subclusters = {"subclusters": subs, "hc": {}}
    _order_pair(jo, to, "tumor", t)
    log = {}
    th._group_cell_order(to, "tumor", t, True, None, device="cpu", pc1_log=log)
    assert list(log) == [("tumor", int(t[0]))]
    rows, proj = log[("tumor", int(t[0]))]
    np.testing.assert_array_equal(rows, t[:40])
    assert proj.shape == (40,)
    jo.tumor_subclusters = to.tumor_subclusters = None
    _order_pair(jo, to, "tumor", t)


def test_heatmap_data_k_obs_groups_split_matches(tmp_path):
    """cluster_by_groups=False with k_obs_groups=3: the groupings file the
    JAX package writes from its split, and the split cached under its key."""
    jo, to = _objects(subclusters=False)
    cache = {}
    d = th.heatmap_data(to, cluster_by_groups=False, k_obs_groups=3, x_center=1.0,
                        row_order_cache=cache, device="cpu")
    jh.plot_cnv(jo, str(tmp_path), output_filename="k", cluster_by_groups=False,
                k_obs_groups=3, x_center=1.0, png_res=30)
    lines = (tmp_path / "k.observation_groupings.txt").read_text().splitlines()[1:]
    assert [f"{g} {to.cell_names[r]}" for (g, n), start in
            zip(d.obs_group_sizes, np.cumsum([0] + [n for _g, n in d.obs_group_sizes]))
            for r in d.obs_idx[start:start + n]] == lines
    assert len(d.obs_group_sizes) == 3
    assert ("all_observations@k", "ward.D", None, 3) in cache


def test_plot_cnv_renders_the_committed_golden(tmp_path):
    """tests/test_heatmap_golden.py's object and arguments through the
    port's plot_cnv: the axes within 1e-3, the 24x24 block means within
    0.02 of tests/data/heatmap_golden.npz."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.image as mpimg
    from matplotlib.figure import Figure

    obj = make_synthetic()
    obj.expr = np.log1p(np.asarray(obj.expr, np.float64)) / 4.0
    to = infercnv_from_numpy(vars(obj))
    captured = {}
    orig = Figure.savefig

    def grab(fig, *a, **k):
        captured["bounds"] = np.array(
            [ax.get_position().bounds for ax in fig.axes], np.float64)
        return orig(fig, *a, **k)

    Figure.savefig = grab
    try:
        th.plot_cnv(to, out_dir=str(tmp_path), output_filename="golden_hm",
                    title="golden", x_center=1.0, x_range=(0.6, 1.4),
                    png_res=120, write_expr=False, device="cpu")
    finally:
        Figure.savefig = orig
    gray = mpimg.imread(os.path.join(tmp_path, "golden_hm.png"))[..., :3].mean(axis=2)
    H, W = gray.shape
    bh, bw = H // 24, W // 24
    blocks = gray[:bh * 24, :bw * 24].reshape(24, bh, 24, bw).mean(axis=(1, 3))
    g = np.load(GOLDEN)
    assert captured["bounds"].shape == g["bounds"].shape
    np.testing.assert_allclose(captured["bounds"], g["bounds"], atol=1e-3)
    np.testing.assert_allclose(blocks, g["blocks"], atol=0.02)


def test_heatmap_data_writes_no_full_size_copy(monkeypatch):
    """The data side reads the [C, G] source only in blocks of at most
    CHUNK_ELEMS elements (shrunk here so the matrix spans many blocks),
    and its results equal a one-block run's."""
    _jo, to = _objects(subclusters=False)
    full = th.heatmap_data(to, device="cpu")
    monkeypatch.setattr(th, "CHUNK_ELEMS", 1000)
    seen = []
    orig = th._Rows._upload

    def watch(self, blocks):
        for b, x in orig(self, blocks):
            seen.append(x.numel())
            yield b, x

    monkeypatch.setattr(th._Rows, "_upload", watch)
    small = th.heatmap_data(to, device="cpu")
    assert len(seen) > 10 and max(seen) <= 1000
    assert (small.x_center, small.lo, small.hi) == (full.x_center, full.lo, full.hi)
    np.testing.assert_array_equal(small.hist_counts, full.hist_counts)
    np.testing.assert_allclose(small.obs_mat, full.obs_mat, rtol=0, atol=1e-6)
