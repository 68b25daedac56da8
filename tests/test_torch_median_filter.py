"""The port's median filter (ops/median_filter.py, on the device) against
the JAX package's (host numpy): equal values.  The windows at a block's
edges hold even counts of values, where numpy averages the two middle
ones; chunked blocks (an r-wide halo) equal whole ones."""

import numpy as np
import pytest

from infercnv_tpu.ops import median_filter as jmf
from infercnv_tpu_torch.interop import infercnv_from_numpy
from infercnv_tpu_torch.ops import median_filter as tmf

from test_pipeline import make_synthetic
from torch_port_util import one_thread_a_pool


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_a_pool():
        yield


@pytest.mark.parametrize("shape,window", [((30, 40), 7), ((5, 3), 3),
                                          ((12, 9), 9), ((50, 200), 5)])
def test_median_filter_block_matches(shape, window):
    rng = np.random.default_rng(sum(shape) + window)
    d = rng.normal(1.0, 0.2, shape)
    d[rng.random(shape) < 0.2] = 1.0                 # ties
    want = jmf._median_filter_block(d, window)
    got = tmf._median_filter_block(d, window, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    chunked = tmf._median_filter_block(d, window, max_plane_elems=1500, device="cpu")
    np.testing.assert_array_equal(chunked.numpy(), want)


def test_even_window_counts_average_the_middle_values():
    """A 4 x 4 block, window 3 (r = 2): the corner's window holds 3 x 3
    values, an edge's 3 x 4 (even), the centre's 4 x 4 (even)."""
    d = np.arange(16, dtype=np.float64).reshape(4, 4) ** 1.5
    got = tmf._median_filter_block(d, 3, device="cpu").numpy()
    np.testing.assert_array_equal(got, jmf._median_filter_block(d, 3))
    assert got[0, 2] == np.median(d[0:3, 0:4])       # 12 values: a mean of two


@pytest.mark.parametrize("case", ["subclusters", "groups", "references_only"])
def test_apply_median_filtering_matches(case):
    o = make_synthetic(seed=4, n_normal=10, n_tumor=14, genes_per_chr=30)
    o.expr = np.random.default_rng(1).normal(1.0, 0.1, o.expr.shape).astype(np.float32)
    kw = {}
    if case == "subclusters":
        tum = o.all_obs_idx()
        o.tumor_subclusters = {"hc": {"tumor": None}, "subclusters": {
            "tumor": {"tumor.1": tum[:6], "tumor.2": tum[6:]}}}
    elif case == "references_only":
        kw = dict(on_observations=False)
    t = infercnv_from_numpy(vars(o))
    jmf.apply_median_filtering(o, window_size=5, **kw)
    out = tmf.apply_median_filtering(t, window_size=5, device="cpu", **kw)
    assert out is t and t.expr.dtype == np.float32
    np.testing.assert_array_equal(t.expr, o.expr)


@pytest.mark.parametrize("window", [4, 1, 0])
def test_invalid_window_is_refused(window):
    t = infercnv_from_numpy(vars(make_synthetic(n_normal=4, n_tumor=4, genes_per_chr=10)))
    with pytest.raises(ValueError, match="odd"):
        tmf.apply_median_filtering(t, window_size=window, device="cpu")
