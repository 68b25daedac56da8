"""The port's public API takes the reference's arguments by position.

For every public function, class ``__init__`` and public method that both
packages define (module by module, at the same path), the reference's
positional parameters must be a prefix of the port's: a call written for
infercnv_tpu binds each argument to the same parameter in
infercnv_tpu_torch.  Parameters the port adds (``device``) come after them
or are keyword-only.  Allowed differences: the samplers of ``sim/`` take a
torch generator ``gen`` where the reference takes a JAX ``key``, and the
kernels' own wrappers (``ops/median.row_median``,
``ops/viterbi_pack.viterbi_packed``) take the port's kernel arguments.
The reference's switches between its Pallas kernels and XLA
(``use_pallas``, ``interpret``) have no counterpart: they may end the
reference's list where the port's ends (a positional ``use_pallas`` then
raises TypeError in the port).

The public names the port lacks are the reference's Pallas entry points and
two helpers of its TPU kernels (``viterbi_pack.default_flags``,
``residual_fused.radix_median_rows``), whose work the port's CUDA kernels
do inside.

A call that passes ``mesh`` by position, as the reference's signatures
place it, runs over the mesh in the port and gives the reference's result
(test_positional_mesh_matches_the_reference)."""

import importlib
import importlib.util
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import infercnv_tpu
import infercnv_tpu.models.hmm as jhmm
import infercnv_tpu_torch
import infercnv_tpu_torch.models.hmm as thmm
from infercnv_tpu.parallel.engine import make_cell_mesh as jax_mesh
from infercnv_tpu_torch.interop import infercnv_from_numpy
from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig, make_cell_mesh

from test_pipeline import make_synthetic
from torch_port_util import gene_orders, hmms, one_thread_a_pool

#: public names of infercnv_tpu with no counterpart in the port
JAX_ONLY = {
    "ops.residual_fused.radix_median_rows",
    "ops.viterbi_pack.default_flags",
    "ops.smoothing.apply_banded_operator_pallas",
    "ops.viterbi_pallas.viterbi_pallas",
}
#: the kernels' wrappers, whose arguments are the port's kernels'
KERNEL_WRAPPERS = {"ops.median.row_median", "ops.viterbi_pack.viterbi_packed"}
#: the reference's Pallas-or-XLA switches
TPU_SWITCHES = ("use_pallas", "interpret")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread_a_pool():
        yield


def _modules(pkg) -> dict:
    """{dotted path below the package: module} of every Python module."""
    out = {"": pkg}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        origin = importlib.util.find_spec(m.name).origin or ""
        if origin.endswith(".py"):
            out[m.name.split(".", 1)[1]] = importlib.import_module(m.name)
    return out


def _public(mod) -> dict:
    """{name: object} of the functions and classes a module defines."""
    return {n: o for n, o in vars(mod).items()
            if not n.startswith("_") and getattr(o, "__module__", None) == mod.__name__
            and (inspect.isfunction(o) or inspect.isclass(o))}


def _pairs(path: str, name: str, jo, to):
    """(qualified name, reference callable, port callable or None)."""
    q = f"{path}.{name}" if path else name
    if not inspect.isclass(jo):
        return [(q, jo, to)]
    out = [(f"{q}.__init__", jo.__init__, to.__init__)]
    for m, f in vars(jo).items():
        if not m.startswith("_") and inspect.isfunction(f):
            out.append((f"{q}.{m}", f, getattr(to, m, None)))
    return out


def _positional(f) -> list:
    return [p.name for p in inspect.signature(f).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def _compared():
    jmods, tmods = _modules(infercnv_tpu), _modules(infercnv_tpu_torch)
    pairs, missing = [], set()
    for path, jm in sorted(jmods.items()):
        tm = tmods.get(path)
        for name, jo in sorted(_public(jm).items()):
            to = getattr(tm, name, None) if tm is not None else None
            if to is None:
                missing.add(f"{path}.{name}")
                continue
            for q, jf, tf in _pairs(path, name, jo, to):
                if tf is None:
                    missing.add(q)
                else:
                    pairs.append((q, jf, tf))
    return pairs, missing


def test_reference_positional_parameters_are_a_prefix_of_the_ports():
    pairs, missing = _compared()
    assert len(pairs) > 200   # the walk reached both packages
    assert missing == JAX_ONLY
    bad = []
    for q, jf, tf in pairs:
        if q in KERNEL_WRAPPERS:
            continue
        want, got = _positional(jf), _positional(tf)
        if q.startswith("sim."):
            want = ["gen" if p == "key" else p for p in want]
        while want and want[-1] in TPU_SWITCHES and len(got) < len(want):
            want = want[:-1]
        if got[:len(want)] != want:
            bad.append((q, want, got))
    assert not bad, bad


def _residual_like(C, G, seed=0):
    """Rows around 1 with a loss and a gain in the last half of the cells."""
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 0.12, (C, G)).astype(np.float32)
    x[C // 2:, G // 4:G // 2] -= 0.45
    x[C // 2:, G // 2:3 * G // 4] += 0.6
    return x


@pytest.mark.parametrize("call", ["predict_hmm_on_groups", "predict_hmm_on_cells",
                                  "viterbi_per_group"])
def test_positional_mesh_matches_the_reference(call):
    """Each call as written for the reference, the 2-shard mesh passed by
    position, against the reference on its 2-device CPU mesh."""
    jobj = make_synthetic()
    jobj.expr = _residual_like(jobj.num_cells, jobj.num_genes)
    tobj = infercnv_from_numpy(vars(jobj))
    jparams, tparams = hmms()
    jm, tm = jax_mesh(2), make_cell_mesh(2, device="cpu")
    if call == "predict_hmm_on_groups":
        groups = {**jobj.obs_groups, **jobj.ref_groups}
        want = jhmm.predict_hmm_on_groups(jobj, jparams, groups, None, jhmm.I6_LEVELS, jm)
        got = thmm.predict_hmm_on_groups(tobj, tparams, groups, None, thmm.I6_LEVELS, tm)
    elif call == "predict_hmm_on_cells":
        want = jhmm.predict_hmm_on_cells(jobj, jparams, jm)
        got = thmm.predict_hmm_on_cells(tobj, tparams, tm)
    else:
        sds = np.full((jobj.num_cells, 6), 0.15)
        want = jhmm.viterbi_per_group(jobj.expr, jobj.gene_order, jparams, sds,
                                      "packed", jm)
        got = thmm.viterbi_per_group(tobj.expr, tobj.gene_order, tparams, sds,
                                     "packed", tm)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got != 3).any() and (got == 3).any()


def test_engine_takes_the_mesh_by_position():
    _, tgo = gene_orders([40, 60, 50])
    _, th = hmms()
    mesh = make_cell_mesh(2, device="cpu")
    engine = CnvEngine(tgo, th, EngineConfig(), mesh)
    assert engine.mesh is mesh
    with pytest.raises(TypeError):
        CnvEngine(tgo, th, EngineConfig(), None, "cpu")


@pytest.mark.parametrize("band", ["window", "coordinates"])
def test_apply_banded_operator_matches_the_reference(band):
    """A BandedGeneOperator applied as the reference's XLA route applies it:
    a window band (the one-row route) and a 10 Mbp coordinates band over
    several tiles (the tiled route), within f32 rounding."""
    from infercnv_tpu.ops import layout as jlayout
    from infercnv_tpu.ops import smoothing as jsm
    from infercnv_tpu_torch.ops import layout as tlayout
    from infercnv_tpu_torch.ops import smoothing as tsm

    jgo, tgo = gene_orders([300, 150, 80, 41, 1, 2])
    if band == "window":
        jop = jlayout.smoothing_operator(jgo, 101)
        top = tlayout.smoothing_operator(tgo, 101)
    else:
        jop = jlayout.coordinate_smoothing_operator(jgo, 10_000_000)
        top = tlayout.coordinate_smoothing_operator(tgo, 10_000_000)
        assert top.side_tiles > 1
    x = np.random.default_rng(3).normal(size=(37, jgo.num_genes)).astype(np.float32)
    got = tsm.apply_banded_operator(x, top, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(jsm.apply_banded_operator(x, jop)),
                               rtol=0, atol=1e-6)


def test_smooth_window_reference_matches_the_reference():
    from infercnv_tpu.ops.smoothing import smooth_window_reference as jref
    from infercnv_tpu_torch.ops.smoothing import smooth_window_reference as tref

    x = np.random.default_rng(4).normal(size=(97, 13))
    for w in (1, 2, 11, 101, 301):
        np.testing.assert_array_equal(tref(x, w), jref(x, w))
