"""The port's tracing (infercnv_tpu_torch/utils/profiling.py): spans and the
``host_syncs`` counter inside CnvEngine's calls, on while a torch.profiler
records and off otherwise; and the benchmark's readers of them
(cnvbench/metrics/ref_stats_ms.py, viterbi_pack_ms.py,
host_syncs_per_job.py, engine_idle_ms.py).  CPU only: device="cpu", every
kernel wrapper on its plain version."""

import types

import numpy as np
import pytest
import torch

from cnvbench import run as bench_run
from cnvbench import trace as bench_trace
from infercnv_tpu_torch.core.genome import GeneOrder
from infercnv_tpu_torch.models.hmm import HMMParams
from infercnv_tpu_torch.parallel import engine as port_engine
from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig
from infercnv_tpu_torch.utils import profiling

#: the three residual routes: engine configuration, genome, route forced by
#: shrinking the shared memory the port plans with (wide_genome)
ROUTES = {
    "fused": ({}, [120, 80, 60, 1], None),
    "wide_genome": ({}, [120, 80, 60, 1], 1_024),
    "wide_band": (dict(smooth_method="coordinates", window_length=80_000),
                  [300, 200, 150], None),
}
MEANS = np.array([0.01, 0.5, 1.0, 1.5, 2.0, 3.0])
SDS = np.array([0.15, 0.18, 0.12, 0.2, 0.22, 0.3])
NEW_METRICS = ("ref_stats_ms", "viterbi_pack_ms", "host_syncs_per_job",
               "engine_idle_ms")


def _gene_order(lens) -> GeneOrder:
    G = int(sum(lens))
    return GeneOrder(names=tuple(f"g{i}" for i in range(G)),
                     chr_names=tuple(f"chr{i + 1}" for i in range(len(lens))),
                     chr_ids=np.repeat(np.arange(len(lens)), lens).astype(np.int32),
                     start=np.arange(G, dtype=np.int64) * 1000,
                     stop=np.arange(G, dtype=np.int64) * 1000 + 500)


def _engine(route, monkeypatch) -> CnvEngine:
    cfg, lens, smem = ROUTES[route]
    if smem is not None:
        monkeypatch.setattr(port_engine, "SMEM_OPTIN_BYTES", smem)
    eng = CnvEngine(_gene_order(lens), HMMParams(means=MEANS, sds=SDS, t=1e-6),
                    EngineConfig(**cfg), device="cpu")
    assert eng.residual_route == route
    return eng


def _inputs(G, cells=48, seed=7):
    rng = np.random.default_rng(seed)
    lam = rng.gamma(2.0, 30.0, G)[None, :] * np.ones((cells, 1))
    lam[cells // 2:, :G // 3] *= 1.5
    counts = rng.poisson(lam).astype(np.uint16)
    nf = float(np.median(counts.sum(axis=1, dtype=np.float64)))
    onehot_ref = np.zeros((2, 16), np.float32)
    onehot_ref[0, :8] = onehot_ref[1, 8:] = 1
    onehot = np.zeros((4, cells), np.float32)
    onehot[np.arange(cells) % 4, np.arange(cells)] = 1
    return counts, nf, onehot_ref, onehot


def _calls(eng):
    """Every entry point the benchmark drives, plus transform_chunk: a list
    of each call's outputs."""
    counts, nf, onehot_ref, onehot = _inputs(eng.gene_order.num_genes)
    ml, mr, noise = stats = eng.ref_stats(counts[:16], nf, onehot_ref)
    half = counts.shape[0] // 2
    final, *acc = eng.subcluster_chunk(counts[:half], nf, ml, mr, noise,
                                       onehot[:, :half])
    final2, *acc = eng.subcluster_chunk(counts[half:], nf, ml, mr, noise,
                                        onehot[:, half:], acc=acc)
    states = eng.viterbi_group_means(acc[0] / acc[1][:, None])
    cells = eng.full_chunk(counts, nf, ml, mr, noise)
    pre = eng.transform_chunk(counts, nf, ml, mr)
    return [*stats, final, final2, *acc, states, *cells, pre]


def _tree(records):
    """Each root span as (name, [children...]), recursively, in opening order."""
    kids = {}
    for r in records:
        kids.setdefault(r.parent, []).append(r)

    def node(r):
        return (r.name, [node(c) for c in kids.get(r.id, [])])

    return [node(r) for r in kids.get(None, [])]


def _viterbi():
    return ("icnv.viterbi", [("icnv.viterbi.pack", []), ("icnv.viterbi.kernel", []),
                             ("icnv.viterbi.unpack", [])])


def _residual(route):
    if route == "fused":
        return [("icnv.residual", [])]
    tail = ([("icnv.residual.tail", [])] if route == "wide_genome" else
            [("icnv.residual.centre", []), ("icnv.residual.tail", [])])
    return [("icnv.residual", [("icnv.residual.clip", []),
                               ("icnv.residual.smooth", []), *tail])]


def _expected(route):
    denoise = [] if route == "fused" else [("icnv.denoise", [])]
    ref = ("icnv.ref_stats", [("icnv.ref_stats.means_log", []),
                              ("icnv.ref_stats.residual", []),
                              ("icnv.ref_stats.noise_bounds", [])])
    sub = ("icnv.chunk", _residual(route) + denoise + [("icnv.group_sums", [])])
    return [ref, sub, sub,
            ("icnv.viterbi_group_means", [("icnv.viterbi.sigma", []), _viterbi()]),
            ("icnv.chunk", _residual(route) + denoise + [_viterbi()]),
            ("icnv.chunk", _residual(route))]


def _profiled(fn):
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    return out, profiling.span_records(), names


def test_the_switch_follows_torch_profiler():
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    assert not profiling.tracing()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.tracing()
        assert isinstance(profiling.span("icnv.x"), profiling._Span)
    assert not profiling.tracing()
    assert profiling.span("icnv.x") is profiling._OFF


def test_span_ranges_are_host_events_without_a_device_annotation():
    """A span's range is a plain host range: a user-scope range
    (torch.profiler.record_function) would be drawn on the device's line
    too, where the benchmark's trace reader counts it as device work."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("icnv.x", "cpu"):
            torch.ones(4).sum()
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "icnv.x"]
    assert len(events) == 1
    assert events[0].scope() != int(torch._C._profiler.RecordScope.USER_SCOPE)
    profiling.reset_spans()


@pytest.mark.parametrize("route", list(ROUTES))
def test_untraced_calls_record_nothing_and_build_no_range(route, monkeypatch):
    eng = _engine(route, monkeypatch)

    def refuse(*a, **k):
        raise AssertionError("a range built with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    profiling.reset_spans()
    _calls(eng)
    with profiling.span("icnv.x", "cpu"):
        profiling.count(profiling.HOST_SYNCS)
        profiling.host_sync("cuda")
    assert profiling.span_records() == [] and profiling.counter_totals() == {}


@pytest.mark.parametrize("route", list(ROUTES))
def test_every_route_records_its_spans_nested(route, monkeypatch):
    eng = _engine(route, monkeypatch)
    _, records, names = _profiled(lambda: _calls(eng))
    assert _tree(records) == _expected(route)
    by_id = {r.id: r for r in records}
    for r in records:
        root = r
        while root.parent is not None:
            root = by_id[root.parent]
        assert r.root == root.id and r.host_end_ns >= r.host_start_ns > 0
        assert r.events is None and r.device == torch.device("cpu")
    assert {r.name for r in records} <= names
    # on the CPU nothing waits for a card
    assert profiling.counter_totals() == {}
    totals = profiling.span_totals()
    assert totals["icnv.chunk"]["count"] == 4
    assert totals["icnv.ref_stats"]["device_ms"] == 0.0
    assert totals["icnv.ref_stats"]["host_ms"] > 0
    profiling.reset_spans()
    assert profiling.span_records() == [] and profiling.span_totals() == {}


def test_streamed_ref_stats_records_its_passes(monkeypatch):
    eng = _engine("fused", monkeypatch)
    counts, nf, onehot_ref, _ = _inputs(eng.gene_order.num_genes)
    monkeypatch.setattr(port_engine, "_STREAM_REF_ELEMENTS", 0)
    off = eng.ref_stats(counts[:16], nf, onehot_ref)
    on, records, names = _profiled(lambda: eng.ref_stats(counts[:16], nf, onehot_ref))
    assert _tree(records) == [_expected("fused")[0]]
    assert {r.name for r in records} <= names
    for a, b in zip(on, off):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", list(ROUTES))
def test_outputs_are_bit_identical_traced(route, monkeypatch):
    eng = _engine(route, monkeypatch)
    off = _calls(eng)
    on, _, _ = _profiled(lambda: _calls(eng))
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_mesh_shards_nest_under_the_mesh_call(monkeypatch):
    from infercnv_tpu_torch.parallel.engine import make_cell_mesh

    eng = _engine("fused", monkeypatch)
    mesh_eng = CnvEngine(eng.gene_order, eng.hmm, eng.config,
                         mesh=make_cell_mesh(2, device="cpu"))
    counts, nf, onehot_ref, onehot = _inputs(eng.gene_order.num_genes)
    ml, mr, noise = eng.ref_stats(counts[:16], nf, onehot_ref)
    _, records, _ = _profiled(lambda: mesh_eng.full_chunk(counts, nf, ml, mr, noise))
    tree = _tree(records)
    assert [n for n, _ in tree] == ["icnv.chunk"]
    shard = ("icnv.chunk", _residual("fused") + [_viterbi()])
    assert tree[0][1] == [shard, shard]


def test_host_sync_counts_only_for_cuda():
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.host_sync("cpu")
        profiling.host_sync(torch.device("cuda", 0), 2)
        profiling.host_upload(np.zeros(3), "cuda")
        profiling.host_upload(torch.zeros(3), torch.device("cuda", 0))
        profiling.host_upload(np.zeros(3), "cpu")
        profiling.host_read(torch.zeros(3))
        profiling.host_read(1.5)
    assert profiling.counter_totals() == {profiling.HOST_SYNCS: 4}
    profiling.reset_spans()
    assert profiling.counter_totals() == {}


def test_step_timer_steps_are_spans():
    profiling.reset_spans()
    timer = profiling.StepTimer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.step("02_gene_filter"):
            with profiling.span("icnv.inner"):
                pass
    assert _tree(profiling.span_records()) == [
        ("icnv.step.02_gene_filter", [("icnv.inner", [])])]
    assert "icnv.step.02_gene_filter" in {
        e.name() for e in prof.profiler.kineto_results.events()}
    assert [r["step"] for r in timer.records] == ["02_gene_filter"]
    profiling.reset_spans()


# ---- the benchmark's readers ----------------------------------------------

MS = 1_000_000


def _ctx(jobs=2):
    """A traced window of 10 ms: the device busy 1-3, 5-6 and 8-9 ms; the
    host in ref_stats 0-2, a chunk 2-7.5 (a shard's chunk nested in it)
    and the caller's own work 7.5-10."""
    dev = [("k", "kernel", 1 * MS, 3 * MS), ("k", "kernel", 5 * MS, 6 * MS),
           ("Memcpy DtoH", "memcpy", 8 * MS, 9 * MS)]
    host = [("cnvbench.window", 0, 10 * MS), ("icnv.ref_stats", 0, 2 * MS),
            ("icnv.chunk", 2 * MS, 7.5 * MS), ("icnv.chunk", 3 * MS, 4 * MS),
            ("icnv.residual", 3 * MS, 4 * MS), ("aten::copy_", 7.5 * MS, 10 * MS)]
    return types.SimpleNamespace(trace=bench_trace.Window(dev, host, (0, 10 * MS)),
                                 jobs=jobs)


TOTALS = {"icnv.ref_stats": {"count": 2, "device_ms": 21.0, "self_device_ms": 1.0,
                             "host_ms": 30.0},
          "icnv.viterbi.pack": {"count": 4, "device_ms": 6.0, "self_device_ms": 6.0,
                                "host_ms": 1.0},
          "icnv.viterbi.unpack": {"count": 4, "device_ms": 2.0, "self_device_ms": 2.0,
                                  "host_ms": 1.0}}


def test_readers_on_a_known_window(monkeypatch):
    monkeypatch.setattr(profiling, "span_totals", lambda: TOTALS)
    monkeypatch.setattr(profiling, "counter_totals", lambda: {profiling.HOST_SYNCS: 15})
    ctx = _ctx(jobs=2)
    assert bench_run.reader("ref_stats_ms")(ctx) == pytest.approx(10.5)
    assert bench_run.reader("viterbi_pack_ms")(ctx) == pytest.approx(4.0)
    assert bench_run.reader("host_syncs_per_job")(ctx) == pytest.approx(7.5)
    # idle: 0-1 (ref_stats), 3-5 (chunk), 6-8 (middle 7: the chunk), 9-10
    # (the caller): 5 ms of the engine's, 2.5 ms a job
    assert bench_run.reader("engine_idle_ms")(ctx) == pytest.approx(2.5)
    assert 2 * 2.5 <= (ctx.trace.window_s - ctx.trace.busy_s) * 1e3
    monkeypatch.setattr(profiling, "span_totals", lambda: {})
    assert bench_run.reader("ref_stats_ms")(ctx) is None
    assert bench_run.reader("viterbi_pack_ms")(ctx) is None


@pytest.mark.parametrize("name", NEW_METRICS)
def test_readers_give_nothing_untraced_or_without_the_program_record(name, monkeypatch):
    assert bench_run.reader(name)(types.SimpleNamespace(trace=None, jobs=3)) is None
    # a program without spans and counters (the benchmark's parent commit)
    for attr in ("span_totals", "counter_totals", "HOST_SYNCS"):
        monkeypatch.delattr(profiling, attr)
    ctx = _ctx()
    if name == "engine_idle_ms":
        ctx.trace.host = [h for h in ctx.trace.host if not h[0].startswith("icnv.")]
    assert bench_run.reader(name)(ctx) is None


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_metrics_are_declared_with_readers_and_cells(name):
    spec = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
    entry = {m["name"]: m for m in spec["per_layer"]}[name]
    assert (bench_run.HERE / "metrics" / f"{name}.py").is_file()
    assert entry["source"] == ("program_counter" if name == "host_syncs_per_job"
                               else "program_span")
    cells = {w["name"] for w in spec["workloads"]}
    assert entry["workloads"] and set(entry["workloads"]) <= cells
    for cell in entry["workloads"]:
        e2e = [m["name"] for m in bench_run.cell_metrics(spec, cell, "end_to_end")]
        assert entry["moves"] in e2e
        assert name in [m["name"] for m in bench_run.cell_metrics(spec, cell, "per_layer")]
