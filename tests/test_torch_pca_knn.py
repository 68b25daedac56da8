"""The port's VST features, PCA embedding and exact kNN
(subcluster/pca.py, subcluster/distance.py) against the JAX package's.

The VST feature indices are equal, from host rows (float64 numpy in both)
and from device rows (float32 moments in both).  With the reference's
range-finder draw handed across (``jax.random.normal(PRNGKey(seed), ...)``
through ``range_omega``), the embeddings' pairwise distances agree within
rtol 1e-4, which holds whatever signs the two SVDs pick.  ``knn_indices``
equals the reference's in one block and in tiles (the sizes monkeypatched
small), and on rows with duplicates, where ties go to the lower index as
``jax.lax.top_k`` breaks them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infercnv_tpu.subcluster import distance as jdist
from infercnv_tpu.subcluster import pca as jpca
from infercnv_tpu_torch.subcluster import distance as tdist
from infercnv_tpu_torch.subcluster import pca as tpca
from torch_port_util import one_thread_a_pool


@pytest.fixture(autouse=True)
def _one_thread_a_pool():
    with one_thread_a_pool():
        yield


def jax_omega(seed, G, k):
    """The reference's range-finder draw (infercnv_tpu/subcluster/pca.py:30)."""
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), (G, k), jnp.float32)))


@pytest.fixture
def handed_omega(monkeypatch):
    monkeypatch.setattr(tpca, "range_omega", jax_omega)


def _clones(n=240, G=2600, seed=3):
    """Residual-like rows around 1 with four clones, each with its own
    raised block of genes of a distinct variance."""
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 0.05, (n, G)).astype(np.float32)
    per = n // 4
    for c in range(4):
        x[c * per:(c + 1) * per, 300 * c:300 * c + 200] += 0.3 * (c + 1)
    x *= rng.uniform(0.5, 2.0, G).astype(np.float32)[None, :]
    return x


@pytest.mark.parametrize("n_features", [500, 2000, 5000])
def test_vst_features_equal(n_features):
    x = _clones()
    want = jpca.variable_features_vst(x, n_features)
    np.testing.assert_array_equal(tpca.variable_features_vst(x, n_features), want)
    want_d = jpca.variable_features_vst(jnp.asarray(x), n_features)
    got_d = tpca.variable_features_vst(torch.from_numpy(x), n_features)
    np.testing.assert_array_equal(got_d, want_d)
    if n_features < x.shape[1]:
        assert want.size == n_features


def test_vst_moments_within_f32_rounding():
    x = _clones()
    mu_j, var_j = jpca._gene_moments(jnp.asarray(x))
    mu_t, var_t = tpca._gene_moments(torch.from_numpy(x))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-6)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), rtol=1e-4)


def _pairwise(e):
    e = np.asarray(e, np.float64)
    return np.sqrt(((e[:, None] - e[None]) ** 2).sum(-1))


@pytest.mark.parametrize("shape,upload", [((240, 2600), None), ((150, 400), None),
                                          ((60, 30), None), ((240, 2600), np.float16)])
def test_embedding_distances_agree(handed_omega, shape, upload):
    x = _clones(*shape)
    if upload is not None:
        x = x.astype(np.float16).astype(np.float32)   # f16-quantized values
    want = np.asarray(jpca.pca_embed(x, 10, upload_dtype=upload))
    got = tpca.pca_embed(x, 10, upload_dtype=upload, device="cpu")
    assert got.shape == want.shape and got.dtype == torch.float32
    dw, dg = _pairwise(want), _pairwise(got.numpy())
    np.testing.assert_allclose(dg, dw, rtol=1e-4, atol=1e-4 * dw.max())
    # tensors on the device take the same route
    got_d = tpca.pca_embed(torch.from_numpy(x), 10)
    np.testing.assert_allclose(_pairwise(got_d.numpy()), dw, rtol=1e-4,
                               atol=1e-4 * dw.max())


def test_degenerate_embedding():
    x = np.ones((2, 1), np.float32)
    assert tpca.pca_embed(x, 10, device="cpu").shape == (2, 1)
    assert np.asarray(jpca.pca_embed(x, 10)).shape == (2, 1)


def test_range_omega_is_a_seeded_cpu_draw():
    a, b = tpca.range_omega(0, 50, 18), tpca.range_omega(0, 50, 18)
    assert a.device.type == "cpu" and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, tpca.range_omega(1, 50, 18))
    assert abs(float(a.mean())) < 0.1 and abs(float(a.std()) - 1.0) < 0.1


def _points(n, G=12, seed=0):
    return np.random.default_rng(seed).normal(size=(n, G)).astype(np.float32)


@pytest.mark.parametrize("n,k", [(50, 1), (50, 20), (300, 20), (3000, 25)])
def test_knn_one_block_equals_reference(n, k):
    x = _points(n)
    want = np.asarray(jdist.knn_indices(x, k))
    got = tdist.knn_indices(x, k, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 0].numpy() == np.arange(n)).all()     # self first


@pytest.mark.parametrize("n", [700, 1000])
def test_knn_tiled_equals_reference(monkeypatch, n):
    for mod in (jdist, tdist):
        monkeypatch.setattr(mod, "_KNN_ONESHOT_MAX", 256)
        monkeypatch.setattr(mod, "_KNN_BLOCK", 128)
    x = _points(n, seed=n)
    want = np.asarray(jdist.knn_indices(x, 20))
    np.testing.assert_array_equal(tdist.knn_indices(x, 20, device="cpu").numpy(), want)
    np.testing.assert_array_equal(tdist.knn_indices(torch.from_numpy(x), 20).numpy(), want)


@pytest.mark.parametrize("tiled", [False, True])
def test_knn_ties_go_to_the_lower_index(monkeypatch, tiled):
    """Rows repeated several times: every copy is at distance 0 from the
    others, and the neighbours list them in index order, as jax.lax.top_k
    does; integer-valued rows give exact distance ties too."""
    if tiled:
        for mod in (jdist, tdist):
            monkeypatch.setattr(mod, "_KNN_ONESHOT_MAX", 64)
            monkeypatch.setattr(mod, "_KNN_BLOCK", 32)
    rng = np.random.default_rng(5)
    base = rng.integers(-2, 3, size=(40, 6)).astype(np.float32)
    x = np.concatenate([base, base[:15], base[:5], base[3:4]])
    x = x[rng.permutation(x.shape[0])]
    want = np.asarray(jdist.knn_indices(x, 10))
    got = tdist.knn_indices(x, 10, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    for q in range(x.shape[0]):
        d = ((x[got[q]] - x[q]) ** 2).sum(1)
        assert (np.diff(d) >= 0).all()
        same = d[1:] == d[:-1]
        assert (got[q][1:][same] > got[q][:-1][same]).all()
