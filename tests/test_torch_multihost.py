"""Two processes under torch.distributed (gloo, localhost, two CPU shards
each: a 4-shard global mesh) against one process, in the manner of
tests/test_multihost.py: tests/torch_multihost_worker.py loads each
process's cell slice with io/sharded.py and runs the sharded median, the
group statistics and the engine ('engine'), or the whole run() ('run').

Each worker is waited on with a time limit, so a collective that hangs
fails its test.  Tolerances: the depth factor and the states exact;
residuals within 1e-6 of the single-process port (the same arithmetic on
other row counts) and 2e-5 of the JAX package (the engine tests'); group
statistics as tests/test_multihost.py holds them (rtol 1e-5 for the means,
1e-3 for the sds against float64); run() expr within 1e-5, the region
reports byte-equal."""

import filecmp
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from test_multihost import _free_port, _make_data, _single_process_reference
from torch_multihost_worker import RUN_KW, build_run_object
from torch_port_util import one_thread_a_pool

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_multihost_worker.py")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_a_pool():
        yield


def _launch(data_dir, mode, timeout):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(rank), "2", str(port), data_dir, mode],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"


def test_two_process_engine_equals_one_process(tmp_path):
    data_dir = str(tmp_path)
    counts, meta = _make_data(data_dir)
    _launch(data_dir, "engine", timeout=240)
    C, G = meta["C"], meta["G"]
    resid = np.full((C, G), np.nan, np.float32)
    states = np.zeros((C, G), np.int8)
    z = [np.load(os.path.join(data_dir, f"out_host{r}.npz")) for r in range(2)]
    for zr in z:
        s0 = int(zr["start"])
        resid[s0:s0 + zr["resid"].shape[0]] = zr["resid"]
        states[s0:s0 + zr["states"].shape[0]] = zr["states"]
    assert not np.isnan(resid).any(), "the processes did not cover every row"
    # every process gathered the whole state matrix
    np.testing.assert_array_equal(z[0]["all_states"], states)
    np.testing.assert_array_equal(z[1]["all_states"], states)

    # the port in one process
    from infercnv_tpu_torch.core.genome import GeneOrder
    from infercnv_tpu_torch.models.hmm import HMMParams
    from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig

    go = GeneOrder(names=tuple(f"g{i}" for i in range(G)),
                   chr_names=tuple(meta["chr_names"]),
                   chr_ids=np.asarray(meta["chr_ids"], np.int32),
                   start=np.asarray(meta["start"]), stop=np.asarray(meta["stop"]))
    engine = CnvEngine(go, HMMParams(means=np.arange(1.0, 7.0) / 3.0,
                                     sds=np.full(6, 0.1), t=1e-6),
                       EngineConfig(window_length=meta["window"], denoise=False),
                       device="cpu")
    nf1 = float(np.median(counts.sum(axis=1)))
    ml, mr, nb = engine.ref_stats(counts[:meta["n_ref"]], nf1)
    r1, s1 = engine.full_chunk(counts, nf1, ml, mr, nb)
    # the JAX package in one process
    j_resid, j_states, j_nf, j_gmean, j_gsd = _single_process_reference(counts, meta)

    assert float(z[0]["norm_factor"]) == float(z[1]["norm_factor"]) == nf1 == j_nf
    np.testing.assert_array_equal(z[0]["gmeans"], z[1]["gmeans"])
    np.testing.assert_allclose(z[0]["gmeans"][0], j_gmean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(z[0]["gsds"][0], j_gsd, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(states, s1.numpy())
    np.testing.assert_array_equal(states, j_states)
    np.testing.assert_allclose(resid, r1.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(resid, j_resid, rtol=2e-5, atol=2e-5)
    assert (states[meta["n_ref"]:, : G // 3] < 3).mean() > 0.7


def test_two_process_run_equals_one_process(tmp_path):
    data_dir = str(tmp_path)
    _counts, meta = _make_data(data_dir)
    _launch(data_dir, "run", timeout=300)
    z0 = np.load(os.path.join(data_dir, "run_out_host0.npz"))
    z1 = np.load(os.path.join(data_dir, "run_out_host1.npz"))
    np.testing.assert_array_equal(z0["states"], z1["states"])
    np.testing.assert_array_equal(z0["expr"], z1["expr"])

    import infercnv_tpu.runner.pipeline as jp
    import infercnv_tpu_torch.runner.pipeline as tp
    from test_multihost import _build_run_object

    kw = dict(RUN_KW, window_length=meta["window"], no_plot=True)
    t_out, j_out = os.path.join(data_dir, "t_single"), os.path.join(data_dir, "j_single")
    rt = tp.run(build_run_object(data_dir, meta), out_dir=t_out, device="cpu", **kw)
    rj = jp.run(_build_run_object(data_dir, meta), out_dir=j_out, **kw)
    for res, tol in ((rt, 1e-6), (rj, 1e-5)):
        np.testing.assert_array_equal(z0["states"], np.asarray(res.hmm_states))
        np.testing.assert_allclose(z0["expr"], np.asarray(res.infercnv_obj.expr),
                                   rtol=0, atol=tol)
    reports = sorted(glob.glob(os.path.join(j_out, "*pred_cnv_regions.dat")))
    assert reports
    for rf in reports:
        for d in (t_out, os.path.join(data_dir, "run_host0"),
                  os.path.join(data_dir, "run_host1")):
            assert filecmp.cmp(os.path.join(d, os.path.basename(rf)), rf,
                               shallow=False), (d, rf)
