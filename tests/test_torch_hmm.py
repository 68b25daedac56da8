"""The port's HMM parameterisations and per-group Viterbi (device="cpu")
against the JAX package's on the same numpy inputs: parameters equal (the
same numpy and scipy arithmetic), states equal."""

import numpy as np
import pytest

from infercnv_tpu.models import hmm as jhmm
from infercnv_tpu_torch.models import hmm as thmm

from torch_port_util import MEANS, SDS, gene_orders


def _params_equal(a, b):
    np.testing.assert_array_equal(a.means, b.means)
    np.testing.assert_array_equal(a.sds, b.sds)
    assert a.t == b.t
    np.testing.assert_array_equal(a.delta(), b.delta())
    np.testing.assert_array_equal(a.log_pi(), b.log_pi())


def test_constants_equal():
    for name in ("I6_LEVELS", "I6_PROXY_VALUES", "I3_PROXY_VALUES",
                 "NEUTRAL_STATE_I6", "NEUTRAL_STATE_I3"):
        np.testing.assert_array_equal(getattr(thmm, name), getattr(jhmm, name))


def test_i6_params_equal():
    cnv = {lvl: (float(m), float(s))
           for lvl, m, s in zip(jhmm.I6_LEVELS, MEANS, SDS)}
    _params_equal(thmm.i6_hmm_params(cnv, t=1e-5), jhmm.i6_hmm_params(cnv, t=1e-5))


@pytest.mark.parametrize("use_ks", [False, True])
@pytest.mark.parametrize("with_refs", [True, False])
def test_i3_params_equal(use_ks, with_refs):
    """Mean and sd of the normal cells' residuals; mean_delta from qnorm
    (Z) or the HoneyBADGER KS fit; without reference groups the observed
    groups stand in (i3HMM.R:17-80)."""
    rng = np.random.default_rng(21)
    expr = rng.normal(1.0, 0.1, (40, 120)).astype(np.float32)
    refs = [np.arange(0, 10), np.arange(10, 16)] if with_refs else []
    obs = [np.arange(16, 40)]
    want = jhmm.i3_hmm_params(expr, refs, obs, t=1e-6, i3_p_val=0.05, use_KS=use_ks)
    got = thmm.i3_hmm_params(expr, refs, obs, t=1e-6, i3_p_val=0.05, use_KS=use_ks)
    _params_equal(got, want)
    assert got.num_states == 3 and got.means[0] < got.means[1] < got.means[2]
    # the port also takes the residuals as a tensor
    import torch

    _params_equal(thmm.i3_hmm_params(torch.from_numpy(expr), refs, obs,
                                     use_KS=use_ks), want)


def test_mean_delta_functions_equal():
    for sigma in (0.05, 0.13, 0.4):
        assert thmm.determine_mean_delta_via_Z(sigma, 0.01) == \
            jhmm.determine_mean_delta_via_Z(sigma, 0.01)
        assert thmm.honeybadger_setGexpDev(sigma, 0.05, 37) == \
            jhmm.honeybadger_setGexpDev(sigma, 0.05, 37)


@pytest.mark.parametrize("S", [3, 6])
def test_proxy_values_equal(S):
    states = np.random.default_rng(S).integers(1, S + 1, (5, 30)).astype(np.int8)
    np.testing.assert_array_equal(thmm.proxy_value_lut(S), jhmm.proxy_value_lut(S))
    np.testing.assert_array_equal(thmm.assign_states_to_proxy_values(states, S),
                                  jhmm.assign_states_to_proxy_values(states, S))
    np.testing.assert_array_equal(
        thmm.assign_states_to_proxy_values(states.astype(np.float64), S),
        jhmm.assign_states_to_proxy_values(states.astype(np.float64), S))


@pytest.mark.parametrize("S", [3, 6])
def test_viterbi_per_group_states_equal(S):
    """Group-mean rows with a gain and a loss, on a genome with a 1-gene
    chromosome (neutral by rule), through both packed implementations; with
    and without per-row state sds."""
    jgo, tgo = gene_orders([120, 60, 40, 25, 1])
    G = jgo.num_genes
    rng = np.random.default_rng(30 + S)
    x = rng.normal(1.0, 0.06, (12, G)).astype(np.float32)
    x[4:8, 10:70] += 0.3
    x[8:, 130:175] -= 0.25
    if S == 3:
        means, sds = np.array([0.8, 1.0, 1.2]), np.full(3, 0.1)
    else:
        means, sds = MEANS, SDS
    jp = jhmm.HMMParams(means=means, sds=sds, t=1e-6)
    tp = thmm.HMMParams(means=means, sds=sds, t=1e-6)
    group_sds = rng.uniform(0.05, 0.15, (12, S))
    for gs in (None, group_sds):
        want = jhmm.viterbi_per_group(x, jgo, jp, gs)
        got = thmm.viterbi_per_group(x, tgo, tp, gs, device="cpu")
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    neutral = (S - 1) // 2 + 1
    assert (got[:, G - 1] == neutral).all()
    assert (got[4:8, 20:60] > neutral).mean() > 0.9
