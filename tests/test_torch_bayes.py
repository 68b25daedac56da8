"""The port's Bayesian filter (infercnv_tpu_torch/models/bayes.py, steps
18-19) against the JAX package's (infercnv_tpu/models/bayes.py).

- region_loglik: the port's moment form against the JAX package's and
  against the dense sum, at rtol = atol = 2e-4 (tests/test_bayes_scale.py's
  tolerance for the moment form).
- The sampler: the two packages draw from different generators (threefry
  keys; mt19937 on the CPU, Philox on the card), so the port's sampler is
  held to its posterior on the cases of tests/test_bayes_scale.py, at their
  tolerances, and to the JAX sampler's posterior on the same
  log-likelihood: theta means within 0.05, the same argmax, cell
  posteriors within 0.08.
- Everything around the sampler is held exactly: with one deterministic
  stand-in for both packages' _gibbs_all_regions
  (torch_port_util.standin_gibbs), bayesian_filter_states gives equal
  states, removed and reassigned regions and byte-equal
  CNV_State_Probabilities.dat, for removeCNV with and without reassignCNV
  and for removeCells.
"""

import filecmp
import os

import jax
import numpy as np
import pytest
import torch

import infercnv_tpu.models.bayes as JB
import infercnv_tpu_torch.models.bayes as TB
from infercnv_tpu.runner.pipeline import run as jax_run
from infercnv_tpu_torch.interop import infercnv_from_numpy

from test_pipeline import make_synthetic
from torch_port_util import one_thread_a_pool, standin_gibbs, standin_margin

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_a_pool():
        yield


def _toy_regions(rng, C=40, G=60, R=3, split=25):
    regions = []
    group_a, group_b = np.arange(0, split), np.arange(split, C)
    for ri in range(R):
        gidx = rng.choice(G, size=rng.integers(5, 15), replace=False)
        regions.append({
            "name": f"r{ri}", "gene_idx": np.sort(gidx),
            "cell_idx": group_a if ri % 2 == 0 else group_b,
            "state": 2, "group": "a" if ri % 2 == 0 else "b",
        })
    return regions


@pytest.mark.parametrize("case", ["subset", "whole_matrix_in_chunks"])
def test_region_loglik_matches_jax_and_dense(case):
    """The subset case reads only the regions' cells (25 of 100); the other
    streams the whole matrix in chunks of 7 rows."""
    rng = np.random.default_rng(0)
    C, G = (100, 60) if case == "subset" else (40, 60)
    x = rng.normal(1.0, 0.4, (C, G)).astype(np.float32)
    mu = np.array([0.4, 1.0, 1.6])
    tau = 1.0 / np.array([0.2, 0.15, 0.3]) ** 2
    if case == "subset":
        regions = _toy_regions(rng, C=40, G=G, split=15)
        regions[1]["cell_idx"] = np.arange(15, 25)
        kw = {}
    else:
        regions = _toy_regions(rng, C, G)
        kw = dict(chunk=7)
    ll, mask = TB.region_loglik(x, regions, mu, tau, device="cpu", **kw)
    jll, jmask = JB.region_loglik(x, regions, mu, tau, **kw)
    assert ll.dtype == torch.float32 and ll.shape == jll.shape
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), **TOL)
    const = 0.5 * np.log(tau / (2 * np.pi))
    for ri, r in enumerate(regions):
        nc = r["cell_idx"].size
        assert mask[ri, :nc].all() and not mask[ri, nc:].any()
        assert not ll[ri, nc:].any()
        for s in range(3):
            dense = (-0.5 * tau[s] * (x[np.ix_(r["cell_idx"], r["gene_idx"])]
                                      - mu[s]) ** 2 + const[s]).sum(axis=1)
            np.testing.assert_allclose(ll[ri, :nc, s].numpy(), dense, **TOL)


def _gibbs(ll, mask, n_chains, n_burn, n_iter, seed=0, thin=1):
    th, ef, tr = TB._gibbs_all_regions(
        TB.block_generator(seed, 0, "cpu"), torch.from_numpy(ll),
        torch.from_numpy(mask), n_chains, n_burn, n_iter, thin=thin)
    return th.numpy(), ef.numpy(), tr.numpy()


def test_gibbs_sharp_posterior_and_masked_counts():
    """All 8 real cells favour state 1 and half the slots are masked: theta
    follows the Dirichlet posterior of the real count, E[theta_1] = 9/11."""
    R, C, S = 1, 16, 3
    ll = np.zeros((R, C, S), np.float32)
    ll[0, :8, 0] = 8.0
    mask = np.zeros((R, C), np.float32)
    mask[0, :8] = 1.0
    ll *= mask[..., None]
    th, ef, tr = _gibbs(ll, mask, 3, 50, 300, seed=2)
    assert abs(th[0, 0] - 9 / 11) < 0.05
    assert ef[0, :8, 0].mean() > 0.95
    assert tr.shape == (3, 300, 1, 3)
    np.testing.assert_allclose(tr.sum(axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(th, tr.mean(axis=(0, 1)), rtol=1e-5)


def _padded_case():
    rng = np.random.default_rng(1)
    R, C, S = 2, 30, 3
    ll = np.zeros((R, C, S), np.float32)
    ll[0, :, 0] = 5.0
    ll[1, :, 2] = 5.0
    ll += rng.normal(0, 0.1, ll.shape).astype(np.float32)
    mask = np.ones((R, C), np.float32)
    mask[1, 20:] = 0.0
    ll *= mask[..., None]
    return ll, mask


def test_gibbs_padding_invariance():
    """Extra masked slots leave the posterior as it was (within Monte Carlo
    error: the draws' shapes differ)."""
    ll, mask = _padded_case()
    R, _, S = ll.shape
    th1, ef1, _ = _gibbs(ll, mask, 3, 50, 200)
    llp = np.concatenate([ll, np.zeros((R, 14, S), np.float32)], axis=1)
    mp = np.concatenate([mask, np.zeros((R, 14), np.float32)], axis=1)
    th2, ef2, _ = _gibbs(llp, mp, 3, 50, 200)
    np.testing.assert_allclose(th1, th2, atol=0.05)
    assert np.argmax(th1, axis=1).tolist() == np.argmax(th2, axis=1).tolist() == [0, 2]
    np.testing.assert_allclose(ef1[0, :30], ef2[0, :30], atol=0.05)


def test_gibbs_matches_the_jax_sampler():
    """The two samplers on one log-likelihood with overlapping states (a
    posterior that is not sharp): the same posterior within Monte Carlo
    error, the reference's thinning of the traces."""
    rng = np.random.default_rng(3)
    R, C, S = 3, 40, 6
    ll = rng.normal(0, 1.0, (R, C, S)).astype(np.float32)
    ll[0, :, 1] += 1.5
    ll[1, :25, 4] += 2.0
    ll[2, :, 2] += 0.7
    mask = np.ones((R, C), np.float32)
    mask[1, 30:] = 0.0
    ll *= mask[..., None]
    th, ef, tr = _gibbs(ll, mask, 6, 200, 1000, thin=3)
    jth, jef, jtr = JB._gibbs_all_regions(jax.random.PRNGKey(0), ll, mask,
                                          6, 200, 1000, thin=3)
    np.testing.assert_allclose(th, np.asarray(jth), atol=0.05)
    assert th.argmax(axis=1).tolist() == np.asarray(jth).argmax(axis=1).tolist()
    np.testing.assert_allclose(ef, np.asarray(jef), atol=0.08)
    assert tr.shape == np.asarray(jtr).shape == (6, 333, R, S)


def test_block_generators_are_distinct_and_repeatable():
    a = torch.rand(4, generator=TB.block_generator(12345, 0, "cpu"))
    b = torch.rand(4, generator=TB.block_generator(12345, 0, "cpu"))
    c = torch.rand(4, generator=TB.block_generator(12345, 1, "cpu"))
    d = torch.rand(4, generator=TB.block_generator(12346, 0, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


@pytest.fixture(scope="module")
def hmm_runs(tmp_path_factory):
    """The JAX package's run() up to step 17 on tests/test_pipeline.py's
    synthetic object, on qnorm subclusters: i6 (the object keeps its
    hspike) and i3.  {name: (JAX object, states, port object)}."""
    out = {}
    for name, kw in {
        "i6": dict(HMM_type="i6", analysis_mode="subclusters",
                   tumor_subcluster_partition_method="qnorm"),
        "i3": dict(HMM_type="i3", analysis_mode="subclusters",
                   tumor_subcluster_partition_method="qnorm"),
    }.items():
        jo = make_synthetic(**(dict(del_factor=0.6, amp_factor=1.6)
                               if name == "i6" else {}))
        r = jax_run(jo, out_dir=str(tmp_path_factory.mktemp(name)), HMM=True,
                    window_length=21, no_plot=True, save_rds=False,
                    up_to_step=17, **kw)
        obj = r.infercnv_obj
        out[name] = (obj, np.asarray(r.hmm_states), infercnv_from_numpy(vars(obj)))
    return out


def _mixtures(run, hmm_type, report_by, monkeypatch=None, budget=None):
    jo, states, to = run
    if budget is not None:
        monkeypatch.setattr(TB, "_GIBBS_TRANSIENT_BUDGET", budget)
    rt, regions_t = TB.run_bayesian_mixture(to, states, hmm_type, to.hspike,
                                            report_by=report_by, device="cpu")
    rj, regions_j = JB.run_bayesian_mixture(jo, states, hmm_type, jo.hspike,
                                            report_by=report_by)
    return rt, rj, regions_t, regions_j


@pytest.mark.parametrize("hmm_type,report_by", [("i6", "subcluster"),
                                                ("i3", "subcluster")])
def test_mixture_matches_the_reference(hmm_runs, hmm_type, report_by):
    """i6 with the reference's hspike carried across (mu, tau from its
    spike distributions) and i3 (mu, tau from the reference cells): the
    same regions, posteriors within 0.05, cell posteriors within 0.08."""
    rt, rj, regions_t, regions_j = _mixtures(hmm_runs[hmm_type], hmm_type, report_by)
    assert len(regions_t) >= 2
    assert rt.cnv_region_names == rj.cnv_region_names
    for a, b in zip(regions_t, regions_j):
        assert a["state"] == b["state"] and a["group"] == b["group"]
        np.testing.assert_array_equal(a["gene_idx"], b["gene_idx"])
        np.testing.assert_array_equal(a["cell_idx"], b["cell_idx"])
    np.testing.assert_allclose(rt.cnv_state_probabilities,
                               rj.cnv_state_probabilities, atol=0.05)
    for a, b in zip(rt.cell_probabilities, rj.cell_probabilities):
        np.testing.assert_allclose(a, b, atol=0.08)
    assert rt.theta_traces.shape == rj.theta_traces.shape
    assert rt.sweeps == TB.N_BURN + TB.N_ITER
    assert set(rt.seconds) == {"regions", "loglik", "sampler"}


def test_region_blocking_matches_single_block(hmm_runs, monkeypatch):
    """A budget that forces one region a block leaves the posteriors within
    Monte Carlo error of one block's, and the traces in region order."""
    one, _, _, _ = _mixtures(hmm_runs["i6"], "i6", "subcluster")
    blk, rj, _, _ = _mixtures(hmm_runs["i6"], "i6", "subcluster",
                              monkeypatch, budget=1)
    R = len(blk.cnv_region_names)
    assert blk.sweeps == R * (TB.N_BURN + TB.N_ITER) and one.sweeps < blk.sweeps
    assert blk.cnv_region_names == one.cnv_region_names == rj.cnv_region_names
    for a, b in ((blk, one), (blk, rj)):
        np.testing.assert_allclose(a.cnv_state_probabilities,
                                   b.cnv_state_probabilities, atol=0.05)
        for x, y in zip(a.cell_probabilities, b.cell_probabilities):
            np.testing.assert_allclose(x, y, atol=0.08)
    assert blk.theta_traces.shape == one.theta_traces.shape
    np.testing.assert_allclose(blk.theta_traces.mean(axis=(0, 1)).T,
                               blk.cnv_state_probabilities, rtol=1e-4)


def _mislabelled(run):
    """The step-17 states with two calls the data do not support: a loss
    over the first 30 genes of chr1 in the reference cells (which the
    filter removes) and the chr3 gain called one state too high (which
    reassignCNV moves)."""
    jo, states, to = run
    st = states.copy()
    ref = jo.all_ref_idx()
    st[np.ix_(ref, np.arange(30))] = 2
    c3 = jo.gene_order.chr_gene_indices("chr3")
    tumour = jo.all_obs_idx()
    gain = st[np.ix_(tumour, c3)] > 3
    st[np.ix_(tumour, c3)] = np.where(gain, 6, st[np.ix_(tumour, c3)])
    return jo, st, to


@pytest.mark.parametrize("method,reassign", [("removeCNV", True),
                                             ("removeCNV", False),
                                             ("removeCells", True)])
def test_filter_is_exact_with_one_standin_sampler(hmm_runs, tmp_path, monkeypatch,
                                                  method, reassign):
    seen = []

    def standin(key, loglik, cell_mask, *a, **k):
        seen.append(standin_margin(loglik, cell_mask))
        return standin_gibbs(key, loglik, cell_mask, *a, **k)

    monkeypatch.setattr(TB, "_gibbs_all_regions", standin)
    monkeypatch.setattr(JB, "_gibbs_all_regions", standin)
    jo, st, to = _mislabelled(hmm_runs["i6"])
    kw = dict(hmm_type="i6", BayesMaxPNormal=0.5, reassign=reassign,
              report_by="subcluster", post_mcmc_method=method)
    ts, tr = TB.bayesian_filter_states(to, st, hspike=to.hspike,
                                       out_dir=str(tmp_path / "t"), device="cpu", **kw)
    js, jr = JB.bayesian_filter_states(jo, st, hspike=jo.hspike,
                                       out_dir=str(tmp_path / "j"), **kw)
    # the stand-in's decisions are exact where no cell's two best states
    # lie within the two packages' rounding of the log-likelihood
    assert min(seen) > 1e-2
    np.testing.assert_array_equal(ts, js)
    assert ts.dtype == js.dtype
    assert tr.removed_regions == jr.removed_regions
    assert tr.reassigned == jr.reassigned
    assert tr.cnv_region_names == jr.cnv_region_names
    np.testing.assert_array_equal(tr.cnv_state_probabilities, jr.cnv_state_probabilities)
    dat = "CNV_State_Probabilities.dat"
    assert filecmp.cmp(tmp_path / "t" / dat, tmp_path / "j" / dat, shallow=False)
    if method == "removeCNV":
        assert tr.removed_regions                  # the reference-cell loss
        assert bool(tr.reassigned) == reassign     # the gain called too high
    else:
        assert not np.array_equal(ts, st)
    assert os.path.getsize(tmp_path / "t" / dat) > 0
