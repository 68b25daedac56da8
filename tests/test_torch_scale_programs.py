"""The port's scale programs (benchmarks/torch_scale1m.py,
torch_scale100k.py, torch_bayes100k.py, torch_scale100k_run.py,
torch_scale1m_run.py) against the JAX package's (benchmarks/scale1m.py,
scale100k.py, bayes100k.py, scale100k_run.py, scale1m_run.py), on the CPU
at toy size.  The JAX programs are imported by path and run themselves:

- their numpy generators (the run programs' counts, bayes100k's genome and
  planted matrices, scale1m's genome) equal the port's bit for bit;
- the engine programs draw their counts with jax.random on the device;
  here that draw is replaced by one numpy table of counts, handed to the
  port's programs as their chunk source, and the engine is wrapped to
  record its states: every chunk's states (cells mode) and the group
  states (subclusters mode) equal the JAX CnvEngine's exactly, and so do
  the summaries (the losses and gains called; the group counts; the group
  sums within float32 summation order, rtol 1e-5);
- bayes100k with the JAX program's calibrated hspike carried across: the
  same modelled regions, posteriors within tests/test_torch_bayes.py's
  tolerances (0.05; cell posteriors 0.08), the gates pass;
- the run programs with the JAX run's hspike, trend fits and PCA draw
  carried across (tests/test_torch_pipeline.py's ``carried``), and its VST
  feature selections: the generator's genes share one spread, so the
  2,000th feature's standardised variance ties with its neighbours', and
  the two packages' residuals (within 2e-5 of each other) pick sets that
  differ by a few features at the cutoff (at most VST_NEAR_TIES of them
  here); with the reference's selection, the same subclusters, the step-17
  states equal (what each run hands to its Bayesian filter) and the step-17
  region reports byte-equal, the gates pass, the JSON line's keys and
  metric equal the reference's.
"""

import filecmp
import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import infercnv_tpu.models.bayes as JB
import infercnv_tpu.parallel.engine as JE
import infercnv_tpu.subcluster.pca as jpca
import infercnv_tpu_torch.models.bayes as TB
from infercnv_tpu_torch.interop import infercnv_from_numpy
from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig
from infercnv_tpu_torch.subcluster import pca as tpca

from test_torch_pca_knn import jax_omega
from test_torch_pipeline import carried  # noqa: F401 (a fixture)
from torch_port_util import one_thread_a_pool

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmarks"
sys.path.insert(0, str(BENCH))
import torch_bayes100k as p_bayes  # noqa: E402
import torch_scale100k as p100k  # noqa: E402
import torch_scale100k_run as p100k_run  # noqa: E402
import torch_scale1m as p1m  # noqa: E402
import torch_scale1m_run as p1m_run  # noqa: E402

CHUNK = 256
N_CHUNKS = 4
#: cells of the toy run() programs
RUN_CELLS = 400
BAYES_CELLS, BAYES_SUBCLUSTERS = 2000, 4
#: features a VST selection of the port may have that the reference's lacks
VST_NEAR_TIES = 10


def _reference(name: str):
    """benchmarks/<name>.py of the JAX package, imported by path."""
    spec = importlib.util.spec_from_file_location(f"reference_{name}", BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_a_pool():
        yield


def _same_genome(jgo, tgo):
    assert tuple(jgo.names) == tuple(tgo.names)
    assert tuple(jgo.chr_names) == tuple(tgo.chr_names)
    for f in ("chr_ids", "start", "stop"):
        np.testing.assert_array_equal(np.asarray(getattr(jgo, f)), getattr(tgo, f))


def _same_groups(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# (a) the numpy generators
# ---------------------------------------------------------------------------

def test_synth_counts_bit_equal():
    ref = _reference("scale100k_run").synth_counts(300)
    got = p100k_run.synth_counts(300)
    _same_genome(ref[0], got[0])
    assert ref[1].dtype == got[1].dtype == np.float32
    np.testing.assert_array_equal(ref[1], got[1])
    _same_groups(ref[2], got[2])
    _same_groups(ref[3], got[3])
    assert list(ref[4]) == list(got[4])
    for g in ref[4]:
        for a, b in zip(ref[4][g], got[4][g]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("gen_counts", [True, False])
def test_synth_counts_streamed_bit_equal(gen_counts):
    ref = _reference("scale1m_run").synth_counts_streamed(300, gen_counts=gen_counts)
    got = p1m_run.synth_counts_streamed(300, gen_counts=gen_counts)
    _same_genome(ref[0], got[0])
    if gen_counts:
        assert ref[1].dtype == got[1].dtype == np.uint16
        np.testing.assert_array_equal(ref[1], got[1])
    else:
        assert ref[1] is None and got[1] is None
    _same_groups(ref[2], got[2])
    _same_groups(ref[3], got[3])
    for g in ref[4]:
        for a, b in zip(ref[4][g], got[4][g]):
            np.testing.assert_array_equal(a, b)


def test_bayes100k_genome_equal():
    jgo, jsizes = _reference("bayes100k").build_genome()
    tgo, tsizes = p_bayes.build_genome()
    _same_genome(jgo, tgo)
    np.testing.assert_array_equal(jsizes, tsizes)


class _Stop(Exception):
    pass


def test_scale1m_genome_and_hmm_equal(monkeypatch):
    """The genome and HMM the JAX program builds its engine from (scale1m.py
    builds them inside main: the engine's constructor is stopped there)."""
    ref = _reference("scale1m")
    seen = {}

    def stop(go, hmm, config):
        seen.update(go=go, hmm=hmm, config=config)
        raise _Stop

    monkeypatch.setattr(ref, "CnvEngine", stop)
    with pytest.raises(_Stop):
        ref.main(C_total=1024, chunk=CHUNK)
    tgo, sizes = p1m.build_genome()
    _same_genome(seen["go"], tgo)
    hmm = p1m.bench_hmm()
    np.testing.assert_array_equal(np.asarray(seen["hmm"].means), hmm.means)
    np.testing.assert_array_equal(np.asarray(seen["hmm"].sds), hmm.sds)
    assert seen["hmm"].t == hmm.t
    assert np.bincount(tgo.chr_ids).tolist() == sizes.tolist()


# ---------------------------------------------------------------------------
# (b) the engine programs on one numpy table of counts
# ---------------------------------------------------------------------------

def _recording(base):
    """A subclass of an engine class that records the states of every
    full_chunk, the last subcluster sums and the group-mean states."""

    class Recording(base):
        seen = None

        def full_chunk(self, *a, **k):
            out = super().full_chunk(*a, **k)
            self.seen.setdefault("cells", []).append(np.asarray(out[1]))
            return out

        def subcluster_chunk(self, *a, **k):
            out = super().subcluster_chunk(*a, **k)
            self.seen["sums"] = (np.asarray(out[1]), np.asarray(out[2]))
            return out

        def viterbi_group_means(self, *a, **k):
            out = super().viterbi_group_means(*a, **k)
            self.seen["groups"] = np.asarray(out)
            return out

    Recording.seen = {}
    return Recording


def _numpy_chunks(has_loss, first_chunk: bool):
    """Poisson counts of the programs' gene means (numpy seed 5): a chunk
    without the loss first where the program draws one, then N_CHUNKS
    chunks with the chr2 loss where has_loss(i)."""
    go, sizes = p1m.build_genome()
    gm, loss = p1m.planted(go.num_genes, sizes)
    rng = np.random.default_rng(5)
    lam = [gm.astype(np.float64), (gm * loss).astype(np.float64)]
    out = [rng.poisson(lam[0], (CHUNK, go.num_genes)).astype(np.float32)] if first_chunk else []
    out += [rng.poisson(lam[int(bool(has_loss(i)))], (CHUNK, go.num_genes))
            .astype(np.float32) for i in range(N_CHUNKS)]
    return out


def _fed(monkeypatch, table):
    """Replace jax.random.poisson by a host callback that hands out the
    table's chunks in order (each program draws its chunks one call at a
    time, in order)."""
    queue = list(table)

    def take():
        return queue.pop(0)

    def fake(key, lam, *a, **k):
        return jax.pure_callback(take, jax.ShapeDtypeStruct(lam.shape, np.float32))

    monkeypatch.setattr(jax.random, "poisson", fake)
    return queue


def _port_engine():
    go, sizes = p1m.build_genome()
    eng = _recording(CnvEngine)(go, p1m.bench_hmm(), EngineConfig(), device="cpu")
    return eng, sizes


@pytest.mark.parametrize("mode", ["cells", "subclusters"])
def test_scale1m_engine_equal(monkeypatch, capsys, mode):
    ref = _reference("scale1m")
    rec = _recording(JE.CnvEngine)
    monkeypatch.setattr(ref, "CnvEngine", rec)
    table = _numpy_chunks(lambda i: i % 2 == 1, first_chunk=True)
    queue = _fed(monkeypatch, table)
    ref.main(C_total=N_CHUNKS * CHUNK, chunk=CHUNK, mode=mode)
    assert not queue
    log = capsys.readouterr().out
    eng, sizes = _port_engine()
    res = p1m.run_stream(eng, sizes, [torch.from_numpy(c) for c in table], mode, CHUNK,
                         lambda i: i % 2 == 1)
    assert res["cells"] == N_CHUNKS * CHUNK
    assert f"norm factor {res['norm_factor']:.0f}" in log
    G = eng.gene_order.num_genes
    if mode == "cells":
        assert len(rec.seen["cells"]) == len(eng.seen["cells"]) == N_CHUNKS
        for a, b in zip(rec.seen["cells"], eng.seen["cells"]):
            np.testing.assert_array_equal(a, b)
        st = np.stack(rec.seen["cells"])
        assert res["n_loss"] == int((st < 3).sum()) and res["n_gain"] == int((st > 3).sum())
        assert (f"deletion fraction {res['n_loss'] / (res['cells'] * G):.4f}" in log)
        assert f"amp fraction {res['n_gain'] / (res['cells'] * G):.5f}" in log
    else:
        np.testing.assert_array_equal(rec.seen["groups"], res["states"].numpy())
        np.testing.assert_array_equal(rec.seen["sums"][1], res["group_counts"].numpy())
        np.testing.assert_allclose(res["group_sums"].numpy(), rec.seen["sums"][0], rtol=1e-5)
        g = res["gates"]
        assert (f"deletion called in planted groups: {g['loss_called_8_15']:.3f}; "
                f"clean groups neutral: {g['neutral_0_7']:.3f}") in log
    assert p1m.passed(res["gates"]), res["gates"]


def test_scale100k_engine_equal(monkeypatch):
    """scale100k.py runs at import: its source runs with its cell count cut
    to N_CHUNKS chunks of CHUNK, and its namespace holds the summaries."""
    path = BENCH / "scale100k.py"
    src = path.read_text()
    line = "C_total, chunk = 102400, 8192"
    assert line in src
    src = src.replace(line, f"C_total, chunk = {N_CHUNKS * CHUNK}, {CHUNK}")
    rec = _recording(JE.CnvEngine)
    monkeypatch.setattr(JE, "CnvEngine", rec)
    table = _numpy_chunks(lambda i: i >= N_CHUNKS // 2, first_chunk=False)
    queue = _fed(monkeypatch, table)
    ns = {"__name__": "reference_scale100k", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    assert not queue
    eng, sizes = _port_engine()
    res = p100k.run_staged(eng, sizes, [torch.from_numpy(c) for c in table])
    assert res["norm_factor"] == ns["norm_factor"]
    assert len(rec.seen["cells"]) == len(eng.seen["cells"]) == N_CHUNKS
    for a, b in zip(rec.seen["cells"], eng.seen["cells"]):
        np.testing.assert_array_equal(a, b)
    assert (res["n_loss"], res["n_gain"]) == (ns["n_del"], ns["n_amp"])
    assert p1m.passed(res["gates"]), res["gates"]


# ---------------------------------------------------------------------------
# (c) steps 18-19 at toy size with the reference's hspike
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bayes_reference():
    """bayes100k.py's main at BAYES_CELLS cells and BAYES_SUBCLUSTERS
    subclusters: its hspike, its filter's inputs and result."""
    ref = _reference("bayes100k")
    seen = {}
    calibrate, filt = ref.calibrated_hspike, JB.bayesian_filter_states

    def hspike(*a, **k):
        seen["hspike"] = calibrate(*a, **k)
        return seen["hspike"]

    def record(obj, states, *a, **k):
        seen.update(expr=np.array(obj.expr), states=np.array(states))
        seen["result"] = filt(obj, states, *a, **k)[1]
        return None, seen["result"]

    with pytest.MonkeyPatch.context() as mp, one_thread_a_pool():
        mp.setattr(ref, "calibrated_hspike", hspike)
        mp.setattr(JB, "bayesian_filter_states", record)
        mp.setattr(sys, "argv", ["bayes100k.py", "--cells", str(BAYES_CELLS),
                                 "--subclusters", str(BAYES_SUBCLUSTERS)])
        ref.main()
    return seen


def test_bayes100k_planted_matrices_bit_equal(bayes_reference):
    hs = infercnv_from_numpy(vars(bayes_reference["hspike"]))
    go, _ = p_bayes.build_genome()
    obj, states, planted = p_bayes.planted_dataset(go, p_bayes.state_means(hs),
                                                   BAYES_CELLS, BAYES_SUBCLUSTERS)
    np.testing.assert_array_equal(obj.expr, bayes_reference["expr"])
    np.testing.assert_array_equal(states.astype(np.int32), bayes_reference["states"])
    assert len(planted) == 6


def test_bayes100k_filter_matches_the_reference(bayes_reference, tmp_path):
    hs = infercnv_from_numpy(vars(bayes_reference["hspike"]))
    go, _ = p_bayes.build_genome()
    obj, states, planted = p_bayes.planted_dataset(go, p_bayes.state_means(hs),
                                                   BAYES_CELLS, BAYES_SUBCLUSTERS)
    _new, rt, _dt = p_bayes.run_filter(obj, states, hs, torch.device("cpu"), str(tmp_path))
    rj = bayes_reference["result"]
    assert rt.cnv_region_names == rj.cnv_region_names
    assert len(rt.regions) == len(rj.regions) >= len(planted)
    for a, b in zip(rt.regions, rj.regions):
        assert a["state"] == b["state"] and a["group"] == b["group"]
        np.testing.assert_array_equal(a["gene_idx"], b["gene_idx"])
        np.testing.assert_array_equal(a["cell_idx"], b["cell_idx"])
    np.testing.assert_allclose(rt.cnv_state_probabilities, rj.cnv_state_probabilities,
                               atol=0.05)
    for a, b in zip(rt.cell_probabilities, rj.cell_probabilities):
        np.testing.assert_allclose(a, b, atol=0.08)
    assert len(rt.removed_regions) == len(rj.removed_regions)
    g = p_bayes.gates(rt, len(planted))
    assert p1m.passed(g), g
    assert set(p_bayes.metric_line(BAYES_CELLS, g["regions"], 1.0)) == {
        "metric", "cells", "regions", "chains", "sweeps", "value", "unit", "cells_per_sec"}


# ---------------------------------------------------------------------------
# (d) the run() programs
# ---------------------------------------------------------------------------

def _filter_inputs(monkeypatch, module, key, seen):
    """Record the states each package hands to its Bayesian filter (step
    17's)."""
    filt = module.bayesian_filter_states

    def record(obj, hmm_states, *a, **k):
        seen[key] = (hmm_states.materialize() if hasattr(hmm_states, "materialize")
                     else np.array(hmm_states))
        return filt(obj, hmm_states, *a, **k)

    monkeypatch.setattr(module, "bayesian_filter_states", record)


def _handed_vst(monkeypatch):
    """The port's step 15 takes the reference run's VST selections, in the
    order they were made; returns the number of features by which each of
    the port's own selections differed."""
    chosen, differ = [], []
    jvst, tvst = jpca.variable_features_vst, tpca.variable_features_vst

    def record(x, *a, **k):
        idx = jvst(x, *a, **k)
        chosen.append(np.asarray(idx))
        return idx

    def replay(x, *a, **k):
        own, ref = np.asarray(tvst(x, *a, **k)), chosen.pop(0)
        differ.append(len(set(own.tolist()) - set(ref.tolist())))
        return ref

    monkeypatch.setattr(jpca, "variable_features_vst", record)
    monkeypatch.setattr(tpca, "variable_features_vst", replay)
    return differ


@pytest.mark.parametrize("program", ["scale100k_run", "scale1m_run"])
def test_run_program_matches_the_reference(monkeypatch, capsys, tmp_path, carried, program):
    import infercnv_tpu.runner.pipeline as jp

    monkeypatch.setattr(tpca, "range_omega", jax_omega)
    vst_differ = _handed_vst(monkeypatch)
    seen = {}
    _filter_inputs(monkeypatch, JB, "jax", seen)
    _filter_inputs(monkeypatch, TB, "port", seen)
    runs = {}
    jrun = jp.run

    def record_run(*a, **k):
        runs["jax"] = jrun(*a, **k)
        return runs["jax"]

    monkeypatch.setattr(jp, "run", record_run)
    ref = _reference(program)
    dj, dt = tmp_path / "jax", tmp_path / "port"
    argv = ["--cells", str(RUN_CELLS), "--no-plot"]
    monkeypatch.setattr(sys, "argv", [f"{program}.py", *argv, "--out_dir", str(dj)])
    ref.main()
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    port = p100k_run if program == "scale100k_run" else p1m_run
    tp_run = p100k_run.run    # both programs call run() through torch_scale100k_run

    def record_port(*a, **k):
        runs["port"] = tp_run(*a, **k)
        return runs["port"]

    monkeypatch.setattr(p100k_run, "run", record_port)
    assert port.main([*argv, "--out_dir", str(dt), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    tline = json.loads(out[-1])
    extras = json.loads(out[-2][2:])
    assert list(tline) == list(jline) and tline["metric"] == jline["metric"]
    assert (tline["cells"], tline["genes"], tline["subclusters"]) == (
        jline["cells"], jline["genes"], jline["subclusters"])
    assert extras["device"] == "cpu" and p100k_run.gates_passed(extras["gates"])

    assert vst_differ and max(vst_differ) <= VST_NEAR_TIES, vst_differ
    rj, rt = runs["jax"], runs["port"]
    subs_j = rj.infercnv_obj.tumor_subclusters["subclusters"]
    subs_t = rt.infercnv_obj.tumor_subclusters["subclusters"]
    assert list(subs_j) == list(subs_t)
    for g in subs_j:
        _same_groups(subs_j[g], subs_t[g])
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    (rep_j,) = dj.glob("17_HMM_pred*.pred_cnv_regions.dat")
    assert filecmp.cmp(rep_j, dt / rep_j.name, shallow=False)
