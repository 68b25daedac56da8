"""CnvEngine.ref_stats' one-shot form on its three row passes (device="cpu":
each wrapper runs its plain PyTorch version) against the JAX engine's
ref_stats and against the op-by-op form the passes replaced
(chip_smoke.ref_stats_ops, the card's yardstick too), for each
configuration that plans another route or another kernel argument:
pyramidal with 1-3 reference groups, mean centring, no bounds, bf16 at a
halfband of at most 64 (the front smooths with bf16 weights) and above it
(f32 weights, as the reference's ref_stats), coordinate smoothing (two side
tiles: the second pass stays ops) and a gene count that is no multiple of 4.

Tolerances as tests/test_torch_engine.py holds ref_stats: rtol 1e-5, atol
1e-6; against the reference's interpreted Pallas engine (the bf16 case at
halfband 50, whose smooth sums its bf16 products in another order),
rtol = atol = 2e-5, as tests/test_torch_routes.py holds it there.  The
op-by-op form and the passes agree to the bit here: on the CPU both run
the same plain ops."""

import numpy as np
import pytest
import torch

from infercnv_tpu.parallel.engine import CnvEngine as JaxEngine
from infercnv_tpu.parallel.engine import EngineConfig as JaxConfig
from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig

from chip_smoke import ref_stats_ops
from torch_port_util import gene_orders, hmms, np_

LENS = [200, 92, 52]
N_REF = 24
COORD = dict(smooth_method="coordinates", window_length=80_000)

#: name: (chromosome lengths, reference groups, config, JAX engine on
#: interpreted Pallas, the planned second pass)
CASES = {
    "pyramidal_k1": (LENS, 1, {}, False, "fused"),
    "pyramidal_k2": (LENS, 2, {}, False, "fused"),
    "pyramidal_k3": (LENS, 3, {}, False, "fused"),
    "mean_centre": (LENS, 2, dict(center_method="mean"), False, "fused"),
    "no_bounds": (LENS, 2, dict(ref_subtract_use_bounds=False), False, "fused"),
    "bf16_halfband_50": (LENS, 2, dict(matmul_dtype="bfloat16"), True, "fused"),
    "bf16_halfband_100": (LENS, 2, dict(matmul_dtype="bfloat16",
                                        window_length=201), False, "fused"),
    "coordinates": ([300, 200, 150], 2, COORD, False, "ops"),
    "genes_341": ([200, 90, 51], 2, {}, False, "fused"),
}


def _data(lens, k, seed=5):
    """u16 reference counts, the norm factor and a [k, N_REF] membership of
    round-robin groups."""
    rng = np.random.default_rng(seed)
    lam = rng.gamma(2.0, 30.0, sum(lens))[None, :] * np.ones((N_REF, 1))
    lam[N_REF // 2:, :lens[0]] *= 1.3
    counts = rng.poisson(lam).astype(np.uint16)
    nf = float(np.median(counts.sum(axis=1, dtype=np.float64)))
    onehot = np.zeros((k, N_REF), np.float32)
    onehot[np.arange(N_REF) % k, np.arange(N_REF)] = 1
    return counts, nf, onehot


@pytest.mark.parametrize("case", list(CASES))
def test_ref_stats_routes(case):
    lens, k, cfg, pallas, route = CASES[case]
    counts, nf, onehot = _data(lens, k)
    jgo, tgo = gene_orders(lens)
    jh, th = hmms()
    te = CnvEngine(tgo, th, EngineConfig(**cfg), device="cpu")
    je = JaxEngine(jgo, jh, JaxConfig(**cfg), use_pallas=pallas)
    assert te.ref_residual_route == route
    if route == "fused":
        assert te.residual_route == "fused"
    if case == "bf16_halfband_100":
        # the chunks' kernel 1 rounds to bf16; ref_stats' front does not
        assert te._w_fused.bf16 and not te._w_smooth.bf16
    if case == "bf16_halfband_50":
        assert te._w_smooth.bf16 and je._w_shifted is not None
    got = te.ref_stats(counts, nf, onehot)
    want = je.ref_stats(counts.astype(np.float32), nf, onehot)
    ops = ref_stats_ops(te, torch.as_tensor(counts), nf, torch.as_tensor(onehot))
    for g, w, o in zip(got, want, ops):
        assert g.dtype == torch.float32
        tol = 2e-5 if pallas else 1e-6
        np.testing.assert_allclose(np_(g), np_(w), rtol=max(tol, 1e-5), atol=tol)
        np.testing.assert_allclose(np_(g), np_(o), rtol=1e-5, atol=1e-6)
