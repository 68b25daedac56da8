"""Shared inputs of the tests that hold infercnv_tpu_torch against infercnv_tpu.

Everything is made from a seed with numpy and handed to both packages as
numpy arrays; the JAX side runs on the CPU (conftest.py), the port on
device="cpu", where each kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import contextlib

import numpy as np
import threadpoolctl
import torch

from infercnv_tpu.core.genome import GeneOrder as JaxGeneOrder
from infercnv_tpu.models.hmm import HMMParams as JaxHMMParams
from infercnv_tpu_torch.core.genome import GeneOrder
from infercnv_tpu_torch.models.hmm import HMMParams

#: i6 emission parameters of the bundled example's hspike (bench.py)
MEANS = np.array([0.135, 0.631, 1.0, 1.346, 1.702, 2.237])
SDS = np.array([0.221, 0.252, 0.211, 0.288, 0.341, 0.457])
#: the round-number i6 parameters of tests/test_parallel.py
MEANS_ROUND = np.array([0.01, 0.5, 1.0, 1.5, 2.0, 3.0])
SDS_ROUND = np.array([0.15, 0.18, 0.12, 0.2, 0.22, 0.3])


def realistic_sizes() -> np.ndarray:
    """22 chromosomes, 8448 genes: the bench workload's genome (bench.py:76-87)."""
    sizes = np.linspace(800, 120, 22).astype(int)
    sizes = (sizes / sizes.sum() * 8448).astype(int)
    sizes[0] += 8448 - sizes.sum()
    return sizes


def genome_fields(lens) -> dict:
    G = int(sum(lens))
    return dict(
        names=tuple(f"g{i}" for i in range(G)),
        chr_names=tuple(f"chr{i + 1}" for i in range(len(lens))),
        chr_ids=np.repeat(np.arange(len(lens)), lens).astype(np.int32),
        start=np.arange(G, dtype=np.int64) * 1000,
        stop=np.arange(G, dtype=np.int64) * 1000 + 500,
    )


def gene_orders(lens):
    """(JAX GeneOrder, port GeneOrder) of the same genome."""
    f = genome_fields(lens)
    return JaxGeneOrder(**f), GeneOrder(**f)


def hmms(means=MEANS_ROUND, sds=SDS_ROUND, t=1e-6):
    """(JAX HMMParams, port HMMParams) with the same fields."""
    return (JaxHMMParams(means=means, sds=sds, t=t),
            HMMParams(means=means, sds=sds, t=t))


def median_cases() -> dict:
    """Rows for the exact medians: odd and even widths, an all-zero row,
    heavy ties, +-inf and -0 (tests/test_kernels_pallas.py:31-48)."""
    rng = np.random.default_rng(7)
    cases = {}
    for (C, G) in [(4, 9), (5, 10), (17, 131), (40, 256), (3, 2), (6, 1)]:
        x = rng.normal(size=(C, G)).astype(np.float32) * 10
        x[0, : G // 2] = -x[0, : G // 2]
        x[min(1, C - 1)] = 0.0
        cases[f"normal_{C}x{G}"] = x
    cases["ties"] = rng.integers(-3, 4, size=(11, 64)).astype(np.float32)
    inf = rng.normal(size=(8, 20)).astype(np.float32)
    inf[0, :3] = np.inf
    inf[1, :12] = -np.inf
    inf[2, 5] = -np.inf
    inf[3, :] = np.inf
    cases["inf"] = inf
    z = np.zeros((6, 8), np.float32)
    z[0, :4] = -0.0
    z[1, :] = -0.0
    z[2, ::2] = -0.0
    z[3, :3] = -1.0
    z[4, :5] = 1.0
    z[5, 3] = -0.0
    cases["neg_zero"] = z
    return cases


def np_(a) -> np.ndarray:
    """A JAX array or torch tensor as numpy (bf16 widened to f32)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu()
        if str(a.dtype) == "torch.bfloat16":
            a = a.float()
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


@contextlib.contextmanager
def one_thread_a_pool():
    """Run a block with one thread in torch's pool and in the BLAS pools.
    The tests are small problems, and the suite runs in several worker
    processes: pools of a thread a core in each of them spin against each
    other (a test of under a second took minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpoolctl.threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def standin_gibbs(key, loglik, cell_mask, n_chains, n_burn, n_iter, thin=1):
    """A deterministic stand-in for both packages' ``_gibbs_all_regions``
    (same arguments and returns, as numpy): each real cell takes the state
    of its largest log-likelihood (eps one-hot), and theta is the posterior
    mean of Dirichlet(1 + counts) over those states, which depends only on
    the integer counts.  So two packages whose log-likelihoods differ by
    rounding give equal results wherever no cell's two best states lie
    within that rounding; ``standin_margin`` is the smallest such gap."""
    ll = np.asarray(loglik, np.float64)
    m = np.asarray(cell_mask, np.float64)
    R, C, S = ll.shape
    eps = np.eye(S)[ll.argmax(axis=-1)]                          # [R, C, S]
    counts = (eps * m[..., None]).sum(axis=1)                     # [R, S]
    theta = (counts + 1.0) / (m.sum(axis=1)[:, None] + S)
    traces = np.broadcast_to(theta, (n_chains, n_iter // thin, R, S)).copy()
    return theta, eps, traces


def standin_margin(loglik, cell_mask) -> float:
    """The smallest gap between a real cell's two largest log-likelihoods."""
    ll = np.sort(np.asarray(loglik, np.float64), axis=-1)
    gap = ll[..., -1] - ll[..., -2]
    return float(gap[np.asarray(cell_mask) > 0].min())


def png_blocks(path) -> np.ndarray:
    """24x24 block means of a PNG's gray levels, as
    tests/test_heatmap_golden.py:_render fingerprints a heatmap."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.image as mpimg

    gray = mpimg.imread(str(path))[..., :3].mean(axis=2)
    H, W = gray.shape
    bh, bw = H // 24, W // 24
    return gray[:bh * 24, :bw * 24].reshape(24, bh, 24, bw).mean(axis=(1, 3))


def assert_same_outputs(dt, dj, skip=("step_timings.tsv",), png_atol=0.02,
                        numeric=(), tol=0.0) -> list:
    """Two output directories hold the same files (walked recursively):
    every text file byte-equal, except files ending in one of `numeric`,
    whose lines of numbers agree within rtol = atol = tol; every PNG the
    same size with its block fingerprint (png_blocks) within png_atol.
    Returns the files."""
    import filecmp
    import os

    import matplotlib.image as mpimg

    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    names = files(dj)
    assert names == files(dt), sorted(set(names) ^ set(files(dt)))
    for f in names:
        a, b = os.path.join(dt, f), os.path.join(dj, f)
        if f in skip:
            continue
        if f.endswith(".png"):
            assert mpimg.imread(a).shape == mpimg.imread(b).shape, f
            np.testing.assert_allclose(png_blocks(a), png_blocks(b), rtol=0,
                                       atol=png_atol, err_msg=f)
        elif f.endswith(tuple(numeric)):
            np.testing.assert_allclose(np.loadtxt(a), np.loadtxt(b), rtol=tol,
                                       atol=tol, err_msg=f)
        else:
            assert filecmp.cmp(a, b, shallow=False), f
    return names
