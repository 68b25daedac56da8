"""The run() pipeline.

Counterpart of infercnv_tpu/runner/pipeline.py (``RunResult`` and ``run``,
lines 33-1121):

  * steps 1-3: the gene filters, the depth factor and the hspike (i6);
  * steps 4-14: on the engine's fast path (``_engine_fast_ok``, :138-166)
    the ``CnvEngine`` transform streamed in cell chunks on the device
    (``_run_engine_residual``), and the same chain on the hspike
    (``_hspike_residual_chain``); otherwise the op-by-op steps (:645-757),
    each op on the device and mirrored onto the hspike: log, scale_data,
    split_references, random_trees, the reference subtractions, the
    threshold (numeric or 'auto'), the smooth (kernels 3 and 5), median
    centring (kernel 7), chromosome-end trimming, invert log;
  * step 15: the Leiden partition (PCA and kNN on the device, from the
    engine's residual kept on the device when it fits), the hclust cuts,
    the per-chromosome subclusters;
  * step 16: outlier pruning;
  * step 17: the i6 or i3 HMM on groups, subclusters (or, for i6 with
    per-chromosome Leiden subclusters, per chromosome) or cells, with the
    region reports;
  * steps 18-19: the Bayesian filter (the region log-likelihood and the
    Gibbs sampler on the device, models/bayes.py) and the filtered
    ``Pnorm_*`` region reports;
  * step 20: the lazy proxy values; step 21: the non-DE gene mask;
    step 22: denoise; step 23: the final object (``.npz`` and RDS);
  * the plots at the reference's call sites and with its arguments: the
    per-step heatmaps (``plot_steps``, op by op), the subcluster plot, the
    preliminary heatmap (step 15), the HMM state and proxy heatmaps (steps
    17 and 20, factorized states in O(K*G)), the Bayes probability plots
    and the MCMC diagnostics (step 18), the final heatmap (step 23), all
    ordered by one ``row_order_cache``.  Each heatmap's data side runs on
    the device (viz/heatmap.py) and its seconds are recorded beside the
    render's (``<step>.data``, ``<step>.render``); a plot that fails logs a
    warning and the run goes on, as in the reference.

With ``save_rds`` each step writes its checkpoint (runner/checkpoint.py;
on the engine path only step 14 of steps 4-14, as the reference does), and
a second run() into the same out_dir resumes from the newest checkpoint
whose arguments match (the scan of :480-537).

The object stays numpy on the host, as the reference keeps it; rows move to
the device only inside the steps that compute there.  Host statistics (the
library sizes and depth factor, the group means of the HMM, the z-score
gene filter, the region reports, denoise) are the reference's numpy,
dtypes included.  ``run(..., device="cpu")`` runs every kernel's plain
version; ``device=None`` runs on CUDA and raises without it.

``n_devices`` / ``mesh`` shard the cell axis of steps 4-14 (the engine's
chunks, ``_stream_cuda``'s lanes, one a shard) and of step 17's Viterbi
over a ``CellMesh`` (parallel/stats.py), on one process or on several
under ``torch.distributed``; the depth factor is then the sharded median.
Every option of the reference's run() runs.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from infercnv_tpu_torch.core.object import InferCNV
from infercnv_tpu_torch.device import DeviceLike, resolve_device
from infercnv_tpu_torch.models import bayes as bayes_mod
from infercnv_tpu_torch.models import hmm as hmm_mod
from infercnv_tpu_torch.models.hspike import build_hspike
from infercnv_tpu_torch.ops import transforms as T
from infercnv_tpu_torch.ops.smoothing import (
    smooth_by_chromosome,
    smooth_by_chromosome_coordinates,
)
from infercnv_tpu_torch.report.regions import generate_cnv_region_reports
from infercnv_tpu_torch.runner import checkpoint as ckpt
from infercnv_tpu_torch.runner.config import RunConfig
from infercnv_tpu_torch.subcluster.partition import (
    PHASE_RSS_GB,
    PHASE_TIMES,
    define_tumor_subclusters,
    split_references,
)
from infercnv_tpu_torch.utils.logging import log_info, log_warn, set_debug
from infercnv_tpu_torch.utils.memmap import is_disk_memmap, read_rows, write_rows
from infercnv_tpu_torch.utils.profiling import StepTimer
from infercnv_tpu_torch.viz.bayes_plots import (
    mcmc_diagnostic_plots,
    plot_cell_probabilities,
    plot_cnv_probabilities,
    post_prob_normal_heatmap,
)
from infercnv_tpu_torch.viz.heatmap import plot_cnv
from infercnv_tpu_torch.viz.subclusters import plot_subclusters

#: The residual of steps 4-14 stays on the device for a Leiden step 15 while
#: 2.2x its float32 bytes (the chunks plus step 15's gene-filtered copy) are
#: under this (reference infercnv_tpu/runner/pipeline.py:237-242, the
#: literal 11e9).
KEEP_RESIDUAL_BYTES = 11e9

#: Above this many elements, step 22 denoises the matrix block by block in
#: place (a disk-memmap residual stays on disk; reference
#: infercnv_tpu/runner/pipeline.py:407, the literal 2_000_000_000).
INPLACE_DENOISE_ELEMENTS = 2_000_000_000


class RunResult:
    """Outputs of run(): the final denoised object, plus HMM products.

    ``hmm_states`` / ``hmm_proxy_values`` are materialized lazily:
    subcluster- and sample-mode runs keep the factorized per-group state
    rows (models.hmm.GroupedStates), and the [C, G] matrices are expanded
    only on first attribute access."""

    def __init__(self):
        self.infercnv_obj: Optional[InferCNV] = None
        self._hmm_states = None           # ndarray [C, G] or GroupedStates
        self._proxy_num_states: Optional[int] = None
        self._hmm_proxy_values: Optional[np.ndarray] = None
        self.hmm_gene_order = None
        self.subclusters_per_chr = None
        self.bayes_result = None
        self.region_reports = None
        self.timer = None

    @property
    def hmm_states(self) -> Optional[np.ndarray]:
        """[C, G] 1-based state matrix (int8)."""
        if self._hmm_states is not None and hasattr(self._hmm_states, "materialize"):
            self._hmm_states = self._hmm_states.materialize()
        return self._hmm_states

    @hmm_states.setter
    def hmm_states(self, value) -> None:
        self._hmm_states = value

    @property
    def hmm_proxy_values(self) -> Optional[np.ndarray]:
        """[C, G] CNV proxy levels (float32)."""
        if self._hmm_proxy_values is None and self._hmm_states is not None \
                and self._proxy_num_states:
            self._hmm_proxy_values = hmm_mod.assign_states_to_proxy_values(
                self.hmm_states, self._proxy_num_states)
        return self._hmm_proxy_values

    @hmm_proxy_values.setter
    def hmm_proxy_values(self, value) -> None:
        self._hmm_proxy_values = value


def _host(a) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _has_multiple_states(states) -> bool:
    """True when more than one distinct state value exists, checked on the
    factorized rows or row chunks with early exit (reference :80-89)."""
    src = np.asarray(getattr(states, "rows", states))
    first = src.flat[0]
    for b in range(0, src.shape[0], 1024):
        if (src[b:b + 1024] != first).any():
            return True
    return False


def _states_matrix(states) -> Optional[np.ndarray]:
    """Expand factorized GroupedStates to [C, G] (no-op on a matrix)."""
    if states is not None and hasattr(states, "materialize"):
        return states.materialize()
    return states


def _engine_fast_ok(cfg: RunConfig, skip_past: int) -> bool:
    """True when steps 4-14 can run as one engine pass per cell chunk
    (copied from the reference, :138-166): not when a resume skips past
    step 0."""
    if cfg.use_engine is False:
        return False
    ok = (not cfg.scale_data
          and cfg.num_ref_groups is None
          and not (cfg.analysis_mode == "subclusters"
                   and cfg.tumor_subcluster_partition_method == "random_trees")
          and not cfg.remove_genes_at_chr_ends
          and not cfg.prune_outliers
          and cfg.smooth_method in ("pyramidinal", "runmeans", "coordinates")
          and isinstance(cfg.max_centered_threshold, (int, float))
          and not isinstance(cfg.max_centered_threshold, bool)
          and not cfg.plot_steps
          and cfg.up_to_step >= 15
          and skip_past == 0)
    if cfg.use_engine is True and not ok:
        raise ValueError(
            "use_engine=True but the configuration requires op-by-op steps "
            "(scale_data / num_ref_groups / random_trees / chr-end trimming / "
            "outlier pruning / auto threshold / plot_steps / up_to_step<15 "
            "are engine-incompatible)")
    return ok


def _plotted(timer: StepTimer, step: str, what: str, fn, *args, **kwargs) -> None:
    """Run one plot call under the step's timer with a `timings` dict, and
    record its data side and render as ``<step>.data`` / ``<step>.render``;
    a failure logs "<what> failed" and the run goes on (plotting must never
    kill an analysis run)."""
    timings: Dict[str, float] = {}
    with timer.step(step):
        try:
            fn(*args, timings=timings, **kwargs)
        except Exception as e:
            log_warn(f"{what} failed: {e}")
    for part, sec in timings.items():
        timer.records.append({"step": f"{step}.{part}", "seconds": round(sec, 4)})


def _plot_states(obj: InferCNV, values, cfg: RunConfig, output_filename: str,
                 title: str, x_center: float, x_range, row_order_cache=None,
                 value_lut=None, timings=None, **plot_kw) -> None:
    """Render a state/proxy-value matrix with the standard heatmap layout
    (reference :410-457; plots at steps 17 and 20, inferCNV_ops.R:1330-1351,
    1483-1500).  values: a [C, G] matrix or a models.hmm.GroupedStates
    (factorized, rendered in O(K*G) without expanding [C, G]).  value_lut:
    state value -> display value (proxy levels); integer matrices without a
    lut display the states themselves (an identity lut).  plot_kw: the
    run's rendering arguments (png_res, hclust_method, ...)."""
    kw = {}
    if hasattr(values, "cell_to_row"):  # GroupedStates
        rows = (np.asarray(value_lut, np.float32)[values.rows]
                if value_lut is not None else values.rows.astype(np.float32))
        kw["row_values"] = (rows, values.cell_to_row)
        view_expr = obj.expr  # only consulted on a row-order cache miss
    else:
        view_expr = np.asarray(values)
        if value_lut is not None:
            kw["value_lut"] = value_lut
        elif view_expr.dtype.kind in "iu":
            kw["value_lut"] = np.arange(int(view_expr.max()) + 1,
                                        dtype=np.float32)
        else:
            view_expr = view_expr.astype(np.float32, copy=False)
    view = InferCNV(
        expr=view_expr, counts=obj.counts,
        gene_order=obj.gene_order, cell_names=list(obj.cell_names),
        ref_groups=obj.ref_groups, obs_groups=obj.obs_groups,
        tumor_subclusters=obj.tumor_subclusters,
    )
    plot_cnv(view, out_dir=cfg.out_dir, output_filename=output_filename,
             title=title, k_obs_groups=cfg.k_obs_groups,
             cluster_by_groups=cfg.cluster_by_groups,
             cluster_references=cfg.cluster_references,
             x_center=x_center, x_range=x_range,
             plot_chr_scale=cfg.plot_chr_scale, chr_lengths=cfg.chr_lengths,
             row_order_cache=row_order_cache, timings=timings, **plot_kw, **kw)


def _bayes_plots(obj: InferCNV, bayes_out, bayes_dir: str, out_dir: str,
                 timings=None) -> None:
    """Step 18's probability plots (reference :974-988)."""
    t0 = time.perf_counter()
    plot_cnv_probabilities(bayes_out, bayes_dir)
    plot_cell_probabilities(bayes_out, bayes_dir)
    if timings is not None:
        timings["render"] = time.perf_counter() - t0
    post_prob_normal_heatmap(obj, bayes_out, bayes_out.regions, out_dir,
                             timings=timings)


def _ref_onehot(obj: InferCNV) -> np.ndarray:
    """reference subtract_ref_expr_from_obs (inferCNV_ops.R:1678-1702):
    refless fallback uses the mean over all (observation) cells."""
    if obj.has_reference_cells():
        groups = list(obj.ref_groups.values())
    else:
        groups = [obj.all_obs_idx()]
    return T.group_onehot(groups, obj.num_cells)


def _hspike_residual_chain(h: InferCNV, cfg: RunConfig, threshold: float,
                           dev: torch.device) -> None:
    """Apply the step 4-14 transform chain to the hspike child on the
    device, as the reference does on host (:169-182): log, subtract,
    clamp, smooth (kernel 3 or 5), median centring (kernel 7), subtract,
    unlog."""
    M = _ref_onehot(h)
    bounds = cfg.ref_subtract_use_mean_bounds

    def subtract(x):
        return T.subtract_ref_expr(x, T.ref_group_gene_means(x, M), bounds)

    x = subtract(T.log2xplus1(h.expr, dev))
    x = T.apply_max_threshold_bounds(x, float(threshold))
    if cfg.smooth_method == "coordinates":
        x = smooth_by_chromosome(x, h.gene_order, 51, "pyramidinal")
    else:
        method = "runmeans" if cfg.smooth_method == "runmeans" else "pyramidinal"
        x = smooth_by_chromosome(x, h.gene_order, cfg.window_length, method)
    x = subtract(T.center_cells(x, "median"))
    h.expr = _host(T.invert_log2(x))


def _mirrored(obj: InferCNV, fn, dev: torch.device, *args) -> None:
    """Apply an expr -> expr op on the device to obj and (recursively) its
    hspike; the result comes back to the host (reference :99-103)."""
    obj.expr = _host(fn(obj.expr, *args, device=dev))
    if obj.hspike is not None:
        _mirrored(obj.hspike, fn, dev, *args)


def _subtract_ref(obj: InferCNV, inv_log: bool, use_bounds: bool,
                  dev: torch.device) -> None:
    """reference _subtract_ref (:106-117) on the device, mirrored onto the
    hspike."""
    x = T._f32(obj.expr, dev)       # one upload for the means and the subtraction
    means = T.ref_group_gene_means(x, _ref_onehot(obj), inv_log=inv_log)
    obj.expr = _host(T.subtract_ref_expr(x, means, use_bounds=use_bounds))
    if obj.hspike is not None:
        _subtract_ref(obj.hspike, inv_log, use_bounds, dev)


def _smooth(obj: InferCNV, cfg: RunConfig, dev: torch.device) -> None:
    """Step 10 (reference :120-135): kernels 3 or 5 on the device."""
    if cfg.smooth_method == "coordinates":
        y = smooth_by_chromosome_coordinates(obj.expr, obj.gene_order,
                                             cfg.window_length, device=dev)
    else:
        y = smooth_by_chromosome(obj.expr, obj.gene_order, cfg.window_length,
                                 cfg.smooth_method, device=dev)
    obj.expr = _host(y)
    if obj.hspike is not None:
        # hspike always uses gene-window smoothing (fake genome positions);
        # coordinates mode mirrors with window 51 (reference :2421-2424)
        h = obj.hspike
        if cfg.smooth_method == "coordinates":
            y = smooth_by_chromosome(h.expr, h.gene_order, 51, "pyramidinal",
                                     device=dev)
        else:
            method = "runmeans" if cfg.smooth_method == "runmeans" else "pyramidinal"
            y = smooth_by_chromosome(h.expr, h.gene_order, cfg.window_length,
                                     method, device=dev)
        h.expr = _host(y)


def _remove_genes_at_chr_ends(obj: InferCNV, window_length: int) -> None:
    """Step 13 (reference :374-380), host."""
    drop = T.genes_at_chr_ends(obj.gene_order, window_length)
    if drop.size == 0:
        raise RuntimeError("No genes removed at chr ends ... something wrong here")
    obj.remove_genes(drop)
    if obj.hspike is not None:
        _remove_genes_at_chr_ends(obj.hspike, window_length)


def _resolve_mesh(cfg: RunConfig, dev: torch.device):
    """The cell-axis mesh of the sharded steps, or None for one device
    (reference :185-194): cfg.mesh as given, or the first cfg.n_devices
    devices of the run's device type."""
    if cfg.mesh is not None:
        mesh = cfg.mesh
    elif cfg.n_devices:
        from infercnv_tpu_torch.parallel.engine import make_cell_mesh

        mesh = make_cell_mesh(cfg.n_devices,
                              device="cpu" if dev.type == "cpu" else None)
    else:
        return None
    if mesh.devices[0].type != dev.type:
        raise ValueError(f"the mesh's devices ({mesh.devices[0].type}) and the "
                         f"run's device ({dev}) differ")
    return mesh


def _norm_factor(obj: InferCNV, mesh=None) -> float:
    """Depth-norm factor = median library size (inferCNV_ops.R:3095), from
    the reference's host float32 sums; under a mesh whose shard count
    divides the cells, the sharded exact median of them (:197-212), the
    same value."""
    libsizes = obj.expr.sum(axis=1)
    if mesh is not None and libsizes.size % mesh.n_shards == 0:
        from infercnv_tpu_torch.parallel.stats import sharded_median, to_host

        return float(to_host(sharded_median(libsizes.astype(np.float32), mesh)))
    return float(np.median(libsizes))


def _stream_plain(engine, src: np.ndarray, out: np.ndarray, chunk: int,
                  nf: float, ml, mr, out_dtype: torch.dtype,
                  keep: Optional[list], mesh=None) -> Dict[str, float]:
    """The chunks one after another: on the CPU, and under a mesh of
    several processes (each chunk's tail padded with ones to the mesh,
    split over its shards and gathered back, as the reference streams,
    :296-327).  A disk memmap's rows go through its file (utils/memmap.py)."""
    for b in range(0, src.shape[0], chunk):
        block = read_rows(src, b, b + chunk)
        nb = block.shape[0]
        if mesh is not None:
            from infercnv_tpu_torch.parallel.stats import to_host

            pad = -nb % mesh.n_shards
            if pad:  # rows are independent: padding never mixes into cells
                block = np.concatenate(
                    [block, np.ones((pad, block.shape[1]), block.dtype)])
            r = torch.from_numpy(to_host(engine.transform_chunk(block, nf, ml, mr)))
        else:
            r = engine.transform_chunk(block, nf, ml, mr)
        write_rows(out, b, r[:nb].to(out_dtype).float().cpu().numpy())
        if keep is not None:
            keep.append((b, nb, r))
    return {}


class _Lane:
    """One shard's path through the card in _stream_cuda: its device's
    engine and reference statistics, two pinned staging buffers each way,
    two device input buffers, and its own copy streams."""

    def __init__(self, engine, ml, mr, rows: int, G: int, odt: torch.dtype):
        dev = engine.device
        self.engine = engine
        self.ml, self.mr = engine.here(ml, mr)
        self.comp = torch.cuda.current_stream(dev)
        self.h2d, self.d2h = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        self.pin_in = [torch.empty((rows, G), dtype=torch.float32, pin_memory=True)
                       for _ in range(2)]
        self.pin_out = [torch.empty((rows, G), dtype=odt, pin_memory=True)
                        for _ in range(2)]
        self.dev_in = [torch.empty((rows, G), dtype=torch.float32, device=dev)
                       for _ in range(2)]
        self.uploaded = [None, None]   # H2D of a slot's pinned buffer done
        self.consumed = [None, None]   # the kernels done reading a slot's buffer


def _stream_cuda(engine, src: np.ndarray, out: np.ndarray, chunk: int,
                 nf: float, ml, mr, out_dtype: torch.dtype,
                 keep: Optional[list], mesh=None) -> Dict[str, float]:
    """Stream the chunks through the card with the copies overlapped: each
    chunk is staged into one of two pinned host buffers, uploaded on a copy
    stream, transformed on the current stream and downloaded into one of
    two pinned buffers on a second copy stream, so the copies of chunk i+1
    and i-1 run beside chunk i's kernels (the reference double-buffers,
    :296-327).  The download is in out_dtype.  Under a mesh of this
    process's devices each shard is a lane of its own (_Lane): its run of
    every chunk's rows (the tail chunk padded with ones to the mesh) goes
    to its own device through its own buffers and streams, so two shards
    on one card share nothing but the card.  With `keep` (a list; one
    device only), each chunk's residual stays on the card as (first row,
    rows, tensor) for step 15.  A disk memmap's rows (the counts staged,
    the residual drained) go through its file, not its mapping
    (utils/memmap.py).  Returns the summed seconds of each part
    (CUDA events for the card's, summed over the lanes; the host clock for
    the pinned staging)."""
    C, G = src.shape
    odt = out_dtype
    devices = mesh.devices if mesh is not None else (engine.device,)
    n = len(devices)
    lane_rows = -(-min(chunk, C) // n)
    lanes = [_Lane(engine.engine_on(d), ml, mr, lane_rows, G, odt)
             for d in devices]

    def event():
        return torch.cuda.Event(enable_timing=True)

    spans = []                # (name, start event, end event)
    host = {"stage": 0.0, "drain": 0.0}
    pending = []              # [(lane, slot, first row, real rows, D2H done)]

    def drain(parts):
        for lane, slot, lo, real, done in parts:
            done.synchronize()
            t0 = time.perf_counter()
            staged = lane.pin_out[slot][:real]
            if is_disk_memmap(out):
                write_rows(out, lo, staged.float().numpy())
            else:
                torch.from_numpy(out[lo:lo + real]).copy_(staged)
            host["drain"] += time.perf_counter() - t0

    for i, b in enumerate(range(0, C, chunk)):
        s = i % 2
        nb = min(chunk, C - b)
        lr = -(-nb // n)          # each lane's rows, the tail padded
        parts = []
        for li, lane in enumerate(lanes):
            lo = b + li * lr
            real = max(0, min(lr, b + nb - lo))
            if lane.uploaded[s] is not None:
                lane.uploaded[s].synchronize()   # chunk i-2's upload left pin_in[s]
            t0 = time.perf_counter()
            lane.pin_in[s][:real].copy_(torch.from_numpy(read_rows(src, lo, lo + real)))
            lane.pin_in[s][real:lr].fill_(1.0)
            host["stage"] += time.perf_counter() - t0
            with torch.cuda.stream(lane.h2d):
                if lane.consumed[s] is not None:
                    lane.h2d.wait_event(lane.consumed[s])
                a = event()
                a.record(lane.h2d)
                lane.dev_in[s][:lr].copy_(lane.pin_in[s][:lr], non_blocking=True)
                lane.uploaded[s] = event()
                lane.uploaded[s].record(lane.h2d)
            spans.append(("h2d", a, lane.uploaded[s]))
            lane.comp.wait_event(lane.uploaded[s])
            a = event()
            a.record(lane.comp)
            with torch.cuda.device(lane.engine.device):
                r = lane.engine.transform_chunk(lane.dev_in[s][:lr], nf,
                                                lane.ml, lane.mr)
            lane.consumed[s] = event()
            lane.consumed[s].record(lane.comp)
            spans.append(("kernels", a, lane.consumed[s]))
            with torch.cuda.stream(lane.d2h):
                lane.d2h.wait_event(lane.consumed[s])
                a = event()
                a.record(lane.d2h)
                lane.pin_out[s][:lr].copy_(r.to(odt), non_blocking=True)
                r.record_stream(lane.d2h)
                done = event()
                done.record(lane.d2h)
            spans.append(("d2h", a, done))
            if keep is not None:
                keep.append((b, nb, r))
            del r
            parts.append((lane, s, lo, real, done))
        if pending:
            drain(pending.pop(0))
        pending.append(parts)
    for p in pending:
        drain(p)
    for d in dict.fromkeys(devices):
        torch.cuda.synchronize(d)
    secs = {"h2d": 0.0, "kernels": 0.0, "d2h": 0.0}
    for name, a, e in spans:
        secs[name] += a.elapsed_time(e) / 1e3
    secs.update(host_stage=host["stage"], host_drain=host["drain"])
    return secs


def _run_engine_residual(obj: InferCNV, cfg: RunConfig, timer: StepTimer,
                         dev: torch.device, mesh=None) -> Optional[list]:
    """STEPS 4-14 as the fused CnvEngine transform (log -> bounds subtract
    -> clamp -> smooth -> median-center -> subtract -> unlog), streamed in
    cell chunks (reference :215-371).  obj.expr holds the raw counts (the
    engine's normalisation is idempotent on normalised input).

    When step 15 will run the Leiden partition on the whole-genome rows and
    the residual fits (the reference's rule, :237-242), the chunks' float32
    residuals stay on the device and are returned as [(first row, rows,
    tensor)] for step 15; otherwise returns None.  Under a mesh the chunks
    split over its shards (a chunk size that divides by the shard count,
    the tail padded with ones), the depth factor is the sharded median, and
    nothing stays on the device (:227-335)."""
    from infercnv_tpu_torch.models.hmm import HMMParams
    from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig

    n_dev = mesh.n_shards if mesh is not None else 1
    log_info("STEPS 04-14: fused engine transform (use_engine fast path"
             + (f", {n_dev}-shard cell mesh)" if mesh is not None else ")"))
    with timer.step("04-14_engine_transform"):
        # retaining the residual on the device costs ~2x C*G*4 bytes
        # (chunks + step 15's gene-filtered copy); the same guard as the
        # reference's, so matrices that fit only because they stream are
        # not held
        resid_bytes = 2.2 * obj.num_cells * obj.num_genes * 4
        keep_device = (cfg.analysis_mode == "subclusters"
                       and cfg.tumor_subcluster_partition_method == "leiden"
                       and not cfg.per_chr_hmm_subclusters
                       and mesh is None
                       and resid_bytes < KEEP_RESIDUAL_BYTES)
        tdtype = cfg.engine_transfer_dtype
        narrow = tdtype in ("float16", "bfloat16")
        # chunks kept for step 15 stay f32; otherwise the kernel stores the
        # download dtype directly (rounding identical to a cast afterwards)
        kernel_out = tdtype if (narrow and not keep_device) else "float32"
        ecfg = EngineConfig(
            window_length=cfg.window_length,
            smooth_method=cfg.smooth_method,
            max_centered_threshold=float(cfg.max_centered_threshold),
            ref_subtract_use_bounds=cfg.ref_subtract_use_mean_bounds,
            center_method="median",
            denoise=False,
            out_dtype=kernel_out,
        )
        # transform-only use: HMM params are placeholders
        params = HMMParams(means=np.arange(1.0, 7.0), sds=np.ones(6), t=1e-6)
        engine = (CnvEngine(obj.gene_order, params, ecfg, mesh=mesh)
                  if mesh is not None
                  else CnvEngine(obj.gene_order, params, ecfg, device=dev))
        if obj.has_reference_cells():
            groups = [np.asarray(v) for v in obj.ref_groups.values()]
        else:
            groups = [obj.all_obs_idx()]
        ref_idx = np.concatenate(groups)
        onehot = np.zeros((len(groups), ref_idx.size), np.float32)
        pos = {int(c): i for i, c in enumerate(ref_idx)}
        for k, g in enumerate(groups):
            onehot[k, [pos[int(c)] for c in g]] = 1.0
        norm_factor = _norm_factor(obj, mesh)
        ml, mr, _ = engine.ref_stats(obj.expr[ref_idx], norm_factor, onehot)
        base_chunk = cfg.engine_chunk_cells or 16384
        chunk = max(base_chunk // n_dev, 1) * n_dev  # divisible by the mesh
        out_bytes = obj.num_cells * obj.num_genes * 4
        if (cfg.residual_memmap_gb is not None
                and out_bytes > cfg.residual_memmap_gb * 1e9):
            mm_path = os.path.join(cfg.out_dir, "_residual.f32.memmap")
            log_info(f"-residual matrix {out_bytes/1e9:.1f} GB -> disk memmap "
                     f"{mm_path} (bounded host RSS)")
            out = np.memmap(mm_path, dtype=np.float32, mode="w+",
                            shape=(obj.num_cells, obj.num_genes))
        else:
            out = np.empty((obj.num_cells, obj.num_genes), np.float32)
        if narrow:
            log_info(f"-engine chunk downloads as {tdtype}"
                     + (" (kernel-direct)" if kernel_out == tdtype else ""))
        # the overlapped stream takes this process's shards; a mesh over
        # several processes gathers every chunk from them
        overlapped = dev.type == "cuda" and (mesh is None or mesh.group is None)
        stream = _stream_cuda if overlapped else _stream_plain
        device_chunks = [] if keep_device else None
        parts = stream(engine, obj.expr, out, chunk, norm_factor, ml, mr,
                       getattr(torch, tdtype) if narrow else torch.float32,
                       device_chunks, mesh)
        obj.expr = out
    for name, sec in parts.items():
        timer.records.append({"step": f"04-14_engine_transform.{name}",
                              "seconds": round(sec, 4)})
    if obj.hspike is not None:
        with timer.step("04-14_hspike_mirror"):
            _hspike_residual_chain(obj.hspike, cfg,
                                   float(cfg.max_centered_threshold), dev)
    return device_chunks


def _clear_noise(obj: InferCNV, cfg: RunConfig) -> None:
    """Step 22 (reference :383-407), host numpy.  Not mirrored onto hspike."""
    if cfg.noise_filter is not None:
        if cfg.noise_filter > 0:
            if obj.has_reference_cells():
                center = float(obj.expr[obj.all_ref_idx()].mean())
            else:
                center = float(obj.expr.mean())
            if cfg.noise_logistic:
                obj.expr = np.asarray(T.depress_log_signal_midpt_val(obj.expr, center, cfg.noise_filter))
            else:
                obj.expr = np.asarray(T.clear_noise(obj.expr, cfg.noise_filter, center))
    else:
        ref_idx = obj.all_ref_idx() if obj.has_reference_cells() else obj.all_obs_idx()
        if cfg.noise_logistic:
            center, spread = T.ref_mean_sd_bounds(obj.expr, ref_idx, cfg.sd_amplifier)
            obj.expr = np.asarray(T.depress_log_signal_midpt_val(obj.expr, float(center), float(spread)))
        else:
            # >8 GB matrices denoise block-wise in place (the buffer is
            # run()-owned: the engine allocated it, maybe as a disk memmap)
            inplace = (isinstance(obj.expr, np.ndarray)
                       and obj.expr.size > INPLACE_DENOISE_ELEMENTS)
            out = T.clear_noise_via_ref_mean_sd(obj.expr, ref_idx, cfg.sd_amplifier,
                                                inplace=inplace)
            obj.expr = out if inplace else np.asarray(out)


def run(obj: InferCNV, out_dir: Optional[str] = None,
        device: DeviceLike = None, **kwargs) -> RunResult:
    """Run the pipeline.  kwargs mirror the reference run() arguments (see
    RunConfig).  ``n_devices`` / ``mesh`` (a parallel.stats.CellMesh of
    ``device``'s type) shard steps 4-14 and step 17's Viterbi over the cell
    axis; the rest runs on ``device``.  Returns a RunResult."""
    cfg = RunConfig(out_dir=out_dir, **kwargs)
    cfg.validate()
    dev = resolve_device(device)
    mesh = _resolve_mesh(cfg, dev)
    if cfg.debug:
        set_debug(True)
    if cfg.out_dir is None:
        raise ValueError("Error, out_dir is NULL, please provide a path")
    os.makedirs(cfg.out_dir, exist_ok=True)

    result = RunResult()
    # shallow: every step rebinds obj.expr (never writes in place)
    obj = obj.shallow_copy()
    timer = StepTimer(cfg.out_dir)
    result.timer = timer
    # one pane ordering shared by the preliminary / state / final heatmaps
    # (the reference orders every pane by the same stored dendrograms)
    row_order_cache: Dict = {}
    plot_kw = dict(png_res=cfg.png_res, hclust_method=cfg.plot_hclust_method,
                   max_pane_rows=2000 if cfg.useRaster else 10**9,
                   output_format=cfg.output_format, device=dev)

    resume_token = f".HMM{cfg.HMM_type}" if cfg.HMM else ""
    hmm_resume_token = f"{resume_token}.hmm_mode-{cfg.analysis_mode}"
    cum_args = ckpt.relevant_args_by_step(cfg)

    # resume scan (reference :480-537)
    skip_past = 0
    resume_step = 0
    resume_states: Optional[np.ndarray] = None
    if cfg.resume_mode and cfg.save_rds:
        orig_obj = obj
        md5 = obj.options.get("counts_md5")
        step, restored, _states = ckpt.scan_resume(cfg.out_dir, cfg, resume_token, md5)
        if (15 <= step <= 16 and cfg.HMM
                and cfg.per_chr_hmm_subclusters
                and cfg.tumor_subcluster_partition_method == "leiden"):
            # the per-chromosome partitions step 17 needs are not
            # checkpointed: resume from step 14 and recompute step 15
            log_warn("resume: per_chr_hmm_subclusters needs step 15 to "
                     "re-run; resuming from step 14 instead")
            step, restored, _states = ckpt.scan_resume(
                cfg.out_dir, cfg, resume_token, md5, max_step=14)
        if step > 0:
            obj = restored
            resume_step = step
            # steps 17-20 checkpoint the HMM chain on the post-step-16
            # matrix, so the expr chain resumes at 16; steps >= 21 carry
            # post-HMM expr edits and resume in place
            skip_past = 16 if 17 <= step <= 20 else step
            if step >= 17:
                if _states is not None:
                    resume_states = np.asarray(_states)
                else:
                    # a 21/22 checkpoint: the HMM states live in the
                    # step-19 (post-Bayes) or step-17 (raw) files
                    _hstep, hstates = ckpt.scan_hmm_states(
                        cfg.out_dir, cfg, resume_token, md5)
                    if hstates is not None:
                        resume_states = hstates
            if cfg.HMM and resume_states is None and resume_step >= 21:
                # the state files are gone and the Viterbi needs the
                # post-16 matrix: resume only up to 16
                log_warn("resume: HMM state checkpoints missing; recomputing HMM chain")
                obj = orig_obj
                resume_step = 0
                skip_past = 0
                step2, restored2, _ = ckpt.scan_resume(
                    cfg.out_dir, cfg, resume_token, md5, max_step=16)
                if step2 > 0:
                    obj = restored2
                    skip_past = step2

    def save(step: int, states: Optional[np.ndarray] = None) -> None:
        if cfg.save_rds and skip_past < step:
            path = os.path.join(cfg.out_dir, ckpt.step_filename(step, resume_token))
            ckpt.save_step(obj, path, cum_args[step - 1], states)
        if cfg.plot_steps and not cfg.no_plot and skip_past < step and 2 <= step <= 16:
            # incremental step plots (reference plot_steps at each stage,
            # :543-556, with its arguments)
            name = f"{step:02d}_{ckpt.STEP_TOKENS[step]}"
            _plotted(timer, f"{step:02d}_step_plot", "step plot", plot_cnv,
                     obj, out_dir=cfg.out_dir, output_filename=f"infercnv.{name}",
                     title=name, k_obs_groups=cfg.k_obs_groups,
                     cluster_by_groups=cfg.cluster_by_groups,
                     cluster_references=cfg.cluster_references,
                     output_format=cfg.output_format, device=dev)

    def done(step: int) -> bool:
        if cfg.up_to_step == step:
            result.infercnv_obj = obj
            return True
        return False

    # STEP 1: incoming data
    log_info("STEP 1: incoming data")
    save(1)
    if done(1):
        return result

    # STEP 2: gene filters (both per-gene-local: one removal, :568-591)
    if skip_past < 2:
        log_info("STEP 02: Removing lowly expressed genes")
        with timer.step("02_gene_filter"):
            drop1 = T.below_min_mean_expr_cutoff(obj.expr, cfg.cutoff)
            if drop1.size:
                log_info(f"Removing {drop1.size} genes below mean expr threshold {cfg.cutoff}")
            drop2 = T.genes_below_min_cells_ref(obj.expr, cfg.min_cells_per_gene)
            drop2 = np.setdiff1d(drop2, drop1)
            if drop1.size + drop2.size == obj.num_genes:
                raise RuntimeError("All genes removed! Must revisit your data, cannot continue")
            if drop2.size:
                log_info(f"Removed {drop2.size} genes with fewer than {cfg.min_cells_per_gene} cells expressing")
            drop = np.union1d(drop1, drop2)
            if drop.size:
                obj.remove_genes(drop)
        save(2)
    if done(2):
        return result

    # STEP 3: depth normalization (+ hspike build).  On the engine path
    # with no checkpoints (no sim_foreground) the counts stay raw on the
    # host, the hspike statistics normalise on the fly and the engine
    # normalises on the device (:593-626)
    raw_engine = (_engine_fast_ok(cfg, skip_past) and not cfg.save_rds
                  and not cfg.sim_foreground)
    if skip_past < 3:
        log_info("STEP 03: normalization by sequencing depth")
        with timer.step("03_normalize+hspike"):
            norm_factor = None
            if raw_engine:
                norm_factor = float(np.median(
                    np.asarray(obj.expr).sum(axis=1, dtype=np.float64)))
                log_info("-engine fast path: counts stay raw on host "
                         f"(device normalization, factor {norm_factor:g})")
            else:
                obj.expr = np.asarray(T.normalize_counts_by_seq_depth(obj.expr))
            if cfg.HMM and cfg.HMM_type == "i6":
                obj.hspike = build_hspike(obj, sim_method=cfg.sim_method,
                                          aggregate_normals=cfg.hspike_aggregate_normals,
                                          seed=cfg.seed,
                                          common_dispersion=cfg.hspike_common_dispersion,
                                          normalize_factor=norm_factor)
            if cfg.sim_foreground:
                # developer/debug option (reference inferCNV_ops.R:592-593)
                from infercnv_tpu_torch.models.hspike import sim_foreground

                sim_foreground(obj, sim_method=cfg.sim_method, seed=cfg.seed)
        save(3)
    if done(3):
        return result

    # STEPS 4-14 on the engine's fast path: one engine pass per cell chunk;
    # with save_rds only the step-14 checkpoint is written (:629-643)
    device_chunks = None
    if _engine_fast_ok(cfg, skip_past) and skip_past < 14:
        device_chunks = _run_engine_residual(obj, cfg, timer, dev, mesh)
        if (not cfg.save_rds and not cfg.save_final_rds
                and obj.counts is not None
                and getattr(obj.counts, "nbytes", 0) > 4_000_000_000):
            # no RDS outputs will ever read the raw counts again
            log_info("-releasing raw counts matrix "
                     f"({obj.counts.nbytes/1e9:.1f} GB; no RDS outputs requested)")
            obj.counts = None
        save(14)  # while skip_past is still < 14
        skip_past = max(skip_past, 14)

    # STEPS 4-14 op by op (reference :645-757): each op on the device, its
    # result back on the host, mirrored onto the hspike
    if skip_past < 4:
        log_info("STEP 04: log transformation of data")
        with timer.step("04_log"):
            _mirrored(obj, T.log2xplus1, dev)
        save(4)
    if done(4):
        return result

    if cfg.scale_data and skip_past < 5:
        log_info("STEP 05: scaling all expression data")
        with timer.step("05_scale"):
            _mirrored(obj, T.scale_infercnv_expr, dev)
        save(5)
    if done(5):
        return result

    if cfg.num_ref_groups is not None and skip_past < 6:
        if not obj.has_reference_cells():
            raise ValueError("no reference cells defined; cannot split into groups")
        log_info(f"STEP 06: splitting reference data into {cfg.num_ref_groups} clusters")
        with timer.step("06_split_references"):
            split_references(obj, cfg.num_ref_groups, "complete", device=dev)
        save(6)
    if done(6):
        return result

    # random_trees subclustering happens pre-residual (reference :674-686)
    if (cfg.analysis_mode == "subclusters"
            and cfg.tumor_subcluster_partition_method == "random_trees"
            and skip_past < 7):
        log_info("STEP 07: computing tumor subclusters via random_trees")
        with timer.step("07_random_trees"):
            define_tumor_subclusters(
                obj, p_val=cfg.tumor_subcluster_pval,
                hclust_method=cfg.hclust_method,
                cluster_by_groups=cfg.cluster_by_groups,
                partition_method="random_trees",
                z_score_filter=cfg.z_score_filter, seed=cfg.seed,
                device=dev)
        save(7)
    if done(7):
        return result

    if skip_past < 8:
        log_info("STEP 08: removing average of reference data (before smoothing)")
        with timer.step("08_subtract_ref"):
            _subtract_ref(obj, False, cfg.ref_subtract_use_mean_bounds, dev)
        save(8)
    if done(8):
        return result

    if cfg.max_centered_threshold is not None and skip_past < 9:
        with timer.step("09_threshold"):
            threshold = cfg.max_centered_threshold
            if isinstance(threshold, str) and threshold == "auto":
                lo, hi = T.get_average_bounds(obj.expr, device=dev)
                threshold = float(np.mean(np.abs([float(lo), float(hi)])))
                log_info(f"Setting max centered thresholds via auto to: +- {threshold:g}")
            log_info(f"STEP 09: apply max centered expression threshold: {threshold}")
            _mirrored(obj, T.apply_max_threshold_bounds, dev, float(threshold))
        save(9)
    if done(9):
        return result

    if skip_past < 10:
        log_info(f"STEP 10: Smoothing data per cell by chromosome ({cfg.smooth_method})")
        with timer.step("10_smooth"):
            _smooth(obj, cfg, dev)
        save(10)
    if done(10):
        return result

    if skip_past < 11:
        log_info("STEP 11: re-centering data across chromosome after smoothing")
        with timer.step("11_center"):
            _mirrored(obj, T.center_cells, dev, "median")
        save(11)
    if done(11):
        return result

    if skip_past < 12:
        log_info("STEP 12: removing average of reference data (after smoothing)")
        with timer.step("12_subtract_ref"):
            _subtract_ref(obj, False, cfg.ref_subtract_use_mean_bounds, dev)
        save(12)
    if done(12):
        return result

    if (cfg.remove_genes_at_chr_ends and cfg.smooth_method != "coordinates"
            and skip_past < 13):
        log_info("STEP 13: removing genes at chr ends")
        with timer.step("13_chr_ends"):
            _remove_genes_at_chr_ends(obj, cfg.window_length)
        save(13)
    if done(13):
        return result

    if skip_past < 14:
        log_info("STEP 14: invert log2(FC) to FC")
        with timer.step("14_invert_log"):
            _mirrored(obj, T.invert_log2, dev)
        save(14)
    if done(14):
        return result

    # STEP 15: subclustering (leiden by default) / plain clustering;
    # random_trees partitioned at step 7
    if skip_past < 15:
        if (cfg.analysis_mode == "subclusters"
                and cfg.tumor_subcluster_partition_method != "random_trees"):
            log_info(f"STEP 15: computing tumor subclusters via {cfg.tumor_subcluster_partition_method}")
            with timer.step("15_subclusters"):
                result.subclusters_per_chr = define_tumor_subclusters(
                    obj,
                    device_chunks=device_chunks,
                    p_val=cfg.tumor_subcluster_pval,
                    k_nn=cfg.k_nn,
                    leiden_method=cfg.leiden_method,
                    leiden_function=cfg.leiden_function,
                    leiden_resolution=cfg.leiden_resolution,
                    leiden_method_per_chr=cfg.leiden_method_per_chr,
                    leiden_function_per_chr=cfg.leiden_function_per_chr,
                    leiden_resolution_per_chr=cfg.leiden_resolution_per_chr,
                    hclust_method=cfg.hclust_method,
                    cluster_by_groups=cfg.cluster_by_groups,
                    partition_method=cfg.tumor_subcluster_partition_method,
                    per_chr_hmm_subclusters=cfg.per_chr_hmm_subclusters,
                    per_chr_hmm_subclusters_references=cfg.per_chr_hmm_subclusters_references,
                    z_score_filter=cfg.z_score_filter,
                    seed=cfg.seed,
                    # f16-transferred residuals carry f16-quantized values, so
                    # moving PCA rows as f16 is lossless and halves the copy
                    pca_upload_dtype=(np.float16
                                      if cfg.engine_transfer_dtype == "float16"
                                      else None),
                    device=dev)
                device_chunks = None  # free the residual kept on the device
            for ph, sec in sorted(PHASE_TIMES.items(), key=lambda kv: -kv[1]):
                rss = {"rss_gb": round(PHASE_RSS_GB[ph], 3)} if PHASE_RSS_GB.get(ph) else {}
                timer.records.append({"step": f"15_subclusters.{ph}",
                                      "seconds": round(sec, 4), **rss})
            if cfg.inspect_subclusters and not cfg.no_plot:
                _plotted(timer, "15_subcluster_plot", "subcluster plot",
                         plot_subclusters, obj, out_dir=cfg.out_dir,
                         output_filename="infercnv_subclusters", **plot_kw)
        elif cfg.analysis_mode != "subclusters":
            log_info("STEP 15: Clustering samples (not defining tumor subclusters)")
            with timer.step("15_clustering"):
                define_tumor_subclusters(
                    obj, p_val=cfg.tumor_subcluster_pval,
                    hclust_method=cfg.hclust_method,
                    cluster_by_groups=cfg.cluster_by_groups, partition_method="none",
                    z_score_filter=cfg.z_score_filter, seed=cfg.seed, device=dev)
        save(15)
        # milestone: the preliminary object (reference :819-822)
        if cfg.save_rds:
            ckpt.save_step(obj, os.path.join(cfg.out_dir, "preliminary.infercnv_obj.npz"),
                           cum_args[14])
        if not (cfg.no_prelim_plot or cfg.no_plot):
            _plotted(timer, "15_prelim_plot", "preliminary plot", plot_cnv,
                     obj, out_dir=cfg.out_dir,
                     output_filename="infercnv.preliminary",
                     title="Preliminary infercnv (pre-noise filtering)",
                     k_obs_groups=cfg.k_obs_groups,
                     cluster_by_groups=cfg.cluster_by_groups,
                     cluster_references=cfg.cluster_references,
                     plot_chr_scale=cfg.plot_chr_scale,
                     chr_lengths=cfg.chr_lengths,
                     write_expr=cfg.write_expr_matrix,
                     write_phylo=cfg.write_phylo,
                     row_order_cache=row_order_cache, **plot_kw)
    device_chunks = None
    if done(15):
        return result

    # STEP 16: optional outlier pruning (reference :851-864)
    if cfg.prune_outliers and skip_past < 16:
        log_info("STEP 16: Removing outliers")
        with timer.step("16_prune_outliers"):
            for o in (obj, obj.hspike):
                if o is not None:
                    o.expr = _host(T.remove_outliers_norm(
                        o.expr, cfg.outlier_method_bound,
                        cfg.outlier_lower_bound, cfg.outlier_upper_bound,
                        device=dev))
        save(16)
    if done(16):
        return result

    # STEP 17: HMM CNV prediction
    hmm_states = None
    if cfg.HMM and resume_states is not None and resume_step >= 17:
        # resume the 17->20 chain: step-17 states are the raw Viterbi
        # calls, step-19 states the post-Bayes filtered ones (:869-875)
        log_info(f"STEP 17: resuming HMM predictions from step-{resume_step} checkpoint")
        hmm_states = resume_states
        result.hmm_states = hmm_states
        result.hmm_gene_order = obj.gene_order
    elif cfg.HMM:
        log_info("STEP 17: HMM-based CNV prediction")
        # the Viterbi's rows shard over the mesh (reference :878-922)
        on_mesh = dict(mesh=mesh) if mesh is not None else dict(device=dev)
        with timer.step("17_hmm"):
            if cfg.HMM_type == "i6":
                cnv_mean_sd = hmm_mod.get_spike_dists(obj.hspike)
                trend_fits = hmm_mod.cnv_mean_sd_trend_fit(obj.hspike, seed=cfg.seed)
                params = hmm_mod.i6_hmm_params(cnv_mean_sd, t=cfg.HMM_transition_prob)
                neutral = hmm_mod.NEUTRAL_STATE_I6
            else:
                params = hmm_mod.i3_hmm_params(
                    obj.expr, list(obj.ref_groups.values()),
                    list(obj.obs_groups.values()),
                    t=cfg.HMM_transition_prob, i3_p_val=cfg.HMM_i3_pval,
                    use_KS=cfg.HMM_i3_use_KS)
                trend_fits = None
                neutral = hmm_mod.NEUTRAL_STATE_I3

            if cfg.analysis_mode == "subclusters":
                if (cfg.per_chr_hmm_subclusters and cfg.HMM_type == "i6"
                        and cfg.tumor_subcluster_partition_method == "leiden"
                        and result.subclusters_per_chr):
                    hmm_states = hmm_mod.predict_hmm_on_subclusters_per_chr(
                        obj, params, result.subclusters_per_chr, trend_fits,
                        device=dev)
                else:
                    groups: Dict[str, np.ndarray] = {}
                    if obj.tumor_subclusters is not None:
                        for _g, subs in obj.tumor_subclusters["subclusters"].items():
                            groups.update(subs)
                    if not groups:
                        log_warn("No subclusters defined, running on whole samples")
                        groups = {**obj.obs_groups, **obj.ref_groups}
                    hmm_states = hmm_mod.predict_hmm_on_groups(
                        obj, params, groups, trend_fits, factorized=True,
                        **on_mesh)
            elif cfg.analysis_mode == "cells":
                hmm_states = hmm_mod.predict_hmm_on_cells(obj, params, **on_mesh)
            else:  # samples
                if cfg.cluster_by_groups:
                    groups = {**obj.obs_groups, **obj.ref_groups}
                else:
                    groups = {"all_observations": obj.all_obs_idx(), **obj.ref_groups}
                hmm_states = hmm_mod.predict_hmm_on_groups(
                    obj, params, groups, trend_fits, factorized=True, **on_mesh)

            result.region_reports = generate_cnv_region_reports(
                obj, hmm_states,
                output_filename_prefix=f"17_HMM_pred{hmm_resume_token}",
                out_dir=cfg.out_dir,
                ignore_neutral_state=neutral,
                by=cfg.HMM_report_by,
            )
        if cfg.save_rds and skip_past < 17:
            save(17, states=_states_matrix(hmm_states))
        result.hmm_states = hmm_states
        result.hmm_gene_order = obj.gene_order
        if not cfg.no_plot:
            _plotted(timer, "17_state_plot", "state plot", _plot_states,
                     obj, hmm_states, cfg,
                     output_filename=f"infercnv.17_HMM_pred{hmm_resume_token}",
                     title="17_HMM_preds", x_center=float(neutral),
                     x_range=(0.0, 6.0) if cfg.HMM_type == "i6" else (1.0, 3.0),
                     row_order_cache=row_order_cache, **plot_kw)
    if done(17):
        return result

    # STEPS 18-19: Bayesian mixture model filtering (reference :950-1009)
    if cfg.HMM and resume_step >= 19 and hmm_states is not None:
        log_info("STEPS 18-19: resuming post-Bayes filtered states from checkpoint")
    elif (cfg.HMM and cfg.BayesMaxPNormal > 0 and hmm_states is not None
            and _has_multiple_states(hmm_states)):
        log_info("STEP 18: Run Bayesian Network Model on HMM predicted CNVs")
        with timer.step("18_bayes"):
            hmm_states, bayes_out = bayes_mod.bayesian_filter_states(
                obj, hmm_states,
                hmm_type=cfg.HMM_type,
                BayesMaxPNormal=cfg.BayesMaxPNormal,
                hspike=obj.hspike,
                reassign=cfg.reassignCNVs,
                out_dir=os.path.join(cfg.out_dir, f"BayesNetOutput{hmm_resume_token}"),
                report_by=cfg.HMM_report_by,
                seed=cfg.seed,
                device=dev,
            )
        for part, sec in bayes_out.seconds.items():
            timer.records.append({"step": f"18_bayes.{part}", "seconds": round(sec, 4)})
        result.bayes_result = bayes_out
        result.hmm_states = hmm_states
        bayes_dir = os.path.join(cfg.out_dir, f"BayesNetOutput{hmm_resume_token}")
        if cfg.plot_probabilities and not cfg.no_plot:
            _plotted(timer, "18_bayes_plots", "Bayes probability plots",
                     _bayes_plots, obj, bayes_out, bayes_dir, cfg.out_dir)
        if cfg.diagnostics:
            # drawn even under no_plot, as the reference does
            try:
                mcmc_diagnostic_plots(bayes_out, bayes_dir)
            except Exception as e:
                log_warn(f"MCMC diagnostic plots failed: {e}")
        save(19, states=hmm_states)
        # the filtered reports also replace the in-memory step-17 reports
        with timer.step("19_region_reports"):
            result.region_reports = generate_cnv_region_reports(
                obj, hmm_states,
                output_filename_prefix=(
                    f"HMM_CNV_predictions{hmm_resume_token}.Pnorm_{cfg.BayesMaxPNormal:g}"),
                out_dir=cfg.out_dir,
                ignore_neutral_state=(hmm_mod.NEUTRAL_STATE_I6 if cfg.HMM_type == "i6"
                                      else hmm_mod.NEUTRAL_STATE_I3),
                by=cfg.HMM_report_by,
            )
    if done(18) or done(19):
        return result

    # STEP 20: states -> proxy expression values (lazy: RunResult expands
    # the [C, G] float matrix only if the caller reads hmm_proxy_values)
    if cfg.HMM and hmm_states is not None:
        log_info("STEP 20: Converting HMM-based CNV states to repr expr vals")
        num_states = 6 if cfg.HMM_type == "i6" else 3
        result._proxy_num_states = num_states
        if not cfg.no_plot:
            _plotted(timer, "20_proxy_plot", "state plot", _plot_states,
                     obj, hmm_states, cfg,
                     output_filename=(f"infercnv.20_HMM_pred{hmm_resume_token}"
                                      f".Pnorm_{cfg.BayesMaxPNormal:g}.repr_intensities"),
                     title="20_HMM_preds.repr_intensities",
                     x_center=1.0, x_range=(-1.0, 3.0),
                     row_order_cache=row_order_cache,
                     value_lut=hmm_mod.proxy_value_lut(num_states), **plot_kw)
    if done(20):
        return result

    # STEP 21: optional DE-gene masking (reference :1035-1047)
    if cfg.mask_nonDE_genes and skip_past < 21:
        if not obj.has_reference_cells():
            raise ValueError("cannot mask non-DE genes without reference cells")
        log_info("STEP 21: Identify and mask non-DE genes")
        from infercnv_tpu_torch.ops.de_mask import mask_non_DE_genes_basic

        with timer.step("21_mask_nonDE"):
            mask_non_DE_genes_basic(
                obj, p_val_thresh=cfg.mask_nonDE_pval, test_use=cfg.test_use,
                center_val=float(obj.expr.mean()),
                require_DE_all_normals=cfg.require_DE_all_normals, device=dev)
        save(21)
    if done(21):
        return result

    # STEP 22: denoising
    if cfg.denoise and skip_past < 22:
        log_info("STEP 22: Denoising")
        with timer.step("22_denoise"):
            _clear_noise(obj, cfg)
        save(22)
    if done(22):
        return result

    # STEP 23: the final object (reference :1061-1083)
    if cfg.save_final_rds and cfg.save_rds:
        with timer.step("23_final_object"):
            ckpt.save_step(obj, os.path.join(cfg.out_dir, "run.final.infercnv_obj.npz"),
                           cum_args[22])
            # also the R image the reference ecosystem reads (add_to_seurat
            # reads run.final.infercnv_obj from out_dir)
            if obj.num_cells * obj.num_genes <= 500_000_000:
                from infercnv_tpu_torch.io.rds import save_rds_infercnv

                try:
                    save_rds_infercnv(
                        obj, os.path.join(cfg.out_dir, "run.final.infercnv_obj"),
                        options={"analysis_mode": cfg.analysis_mode,
                                 "HMM_report_by": cfg.HMM_report_by,
                                 "HMM_type": cfg.HMM_type if cfg.HMM else "",
                                 "BayesMaxPNormal": cfg.BayesMaxPNormal})
                except Exception as e:  # interop write must never kill a run
                    log_warn(f"run.final.infercnv_obj RDS write failed: {e}")
            else:
                log_warn("skipping run.final.infercnv_obj RDS (matrix > 5e8 "
                         "elements; the gzipped float64 R image would be tens "
                         "of GB — use the .npz checkpoint instead)")
    if not cfg.no_plot:
        _plotted(timer, "23_final_plot", "final heatmap", plot_cnv,
                 obj, out_dir=cfg.out_dir, output_filename="infercnv",
                 title=cfg.title, obs_title=cfg.title_obs,
                 ref_title=cfg.title_ref, contig_lab_size=cfg.contig_lab_size,
                 color_safe_pal=cfg.color_safe,
                 custom_color_pal=cfg.custom_color_pal,
                 ref_contig=cfg.ref_contig, dynamic_resize=cfg.dynamic_resize,
                 k_obs_groups=cfg.k_obs_groups,
                 cluster_by_groups=cfg.cluster_by_groups,
                 cluster_references=cfg.cluster_references,
                 x_center=(cfg.final_center_val if cfg.final_center_val is not None
                           else 1.0),
                 x_range=(cfg.final_scale_limits if cfg.final_scale_limits is not None
                          else "auto"),
                 plot_chr_scale=cfg.plot_chr_scale, chr_lengths=cfg.chr_lengths,
                 write_expr=cfg.write_expr_matrix, write_phylo=cfg.write_phylo,
                 row_order_cache=row_order_cache, **plot_kw)

    timer.finish()
    result.infercnv_obj = obj
    return result
