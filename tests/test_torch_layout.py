"""The port's copied host layouts (genome, smoothing operator, Viterbi
packing) are array-equal to the JAX package's."""

import numpy as np
import pytest

from infercnv_tpu.ops import layout as jlayout
from infercnv_tpu.ops import viterbi_pack as jpack
from infercnv_tpu_torch.ops import layout as tlayout
from infercnv_tpu_torch.ops import viterbi_pack as tpack

from torch_port_util import gene_orders, realistic_sizes

GENOMES = {
    "binpacked": [100, 40, 30, 20, 1],        # tests/test_parallel.py:174-181
    "mixed": [300, 150, 80, 41, 1, 2],
    "small3": [96, 96, 96],
    "realistic": list(realistic_sizes()),
}


@pytest.mark.parametrize("name", sorted(GENOMES))
def test_chr_ranges_equal(name):
    jgo, tgo = gene_orders(GENOMES[name])
    assert tgo.chr_ranges() == jgo.chr_ranges()
    assert tgo.num_genes == jgo.num_genes
    assert tgo.fingerprint() == jgo.fingerprint()


@pytest.mark.parametrize("window,method", [(11, "pyramidinal"), (101, "pyramidinal"),
                                           (51, "runmeans")])
@pytest.mark.parametrize("name", ["binpacked", "mixed"])
def test_smoothing_operator_arrays_equal(name, window, method):
    jgo, tgo = gene_orders(GENOMES[name])
    jop = jlayout.smoothing_operator(jgo, window, method)
    top = tlayout.smoothing_operator(tgo, window, method)
    kernel = (jlayout.pyramidal_kernel(window) if method == "pyramidinal"
              else jlayout.boxcar_kernel(window))
    band, t = jlayout._band_from_kernel(jgo.chr_ranges(), jgo.num_genes, kernel)
    assert top.halfband == t == jop.halfband
    np.testing.assert_array_equal(top.band, band)
    np.testing.assert_array_equal(top.blocks, jop.blocks)
    np.testing.assert_array_equal(top.stacked_blocks(), jop.stacked_blocks())
    if jop.halfband <= 64:
        np.testing.assert_array_equal(top.shifted_blocks(), jop.shifted_blocks())
    x = np.random.default_rng(0).normal(size=(3, jgo.num_genes))
    np.testing.assert_array_equal(top.apply_np(x), jop.apply_np(x))


def test_coordinate_operator_equal():
    jgo, tgo = gene_orders([120, 60, 30])
    jop = jlayout.coordinate_smoothing_operator(jgo, 200_000)
    top = tlayout.coordinate_smoothing_operator(tgo, 200_000)
    assert top.halfband == jop.halfband
    np.testing.assert_array_equal(top.blocks, jop.blocks)


@pytest.mark.parametrize("name", sorted(GENOMES))
def test_packed_layout_equal(name):
    jgo, tgo = gene_orders(GENOMES[name])
    jl = jpack.PackedLayout.from_gene_order(jgo)
    tl = tpack.get_layout(tgo)
    assert tl.Lmax == jl.Lmax and tl.num_genes == jl.num_genes
    for field in ("gather", "valid", "boundaries", "inv_pack"):
        got, want = getattr(tl, field), getattr(jl, field)
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    if jl.short_genes is None:
        assert tl.short_genes is None
    else:
        np.testing.assert_array_equal(tl.short_genes, jl.short_genes)
    assert tpack.layout_key(tgo) == jpack.layout_key(jgo)


def test_realistic_genome_shapes():
    """The main path's shapes: 8448 = 66 x 128 genes, halfband 50, one side
    tile, Lmax 678 in 13 bins (B = 16 x 13 = 208 subcluster sequences)."""
    _, tgo = gene_orders(GENOMES["realistic"])
    op = tlayout.smoothing_operator(tgo, 101)
    assert (op.num_genes, op.n_tiles, op.halfband, op.side_tiles) == (8448, 66, 50, 1)
    assert op.band.shape == (101, 8448)
    lay = tpack.get_layout(tgo)
    assert lay.Lmax == 678 and lay.gather.shape == (13, 678)
