"""Run configuration: mirrors the ~70 keyword args of the reference's
run() (R/inferCNV_ops.R:242-348); names and defaults are API.

Copied from infercnv_tpu/runner/config.py (``RunConfig`` and ``validate``,
all of it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union


@dataclasses.dataclass
class RunConfig:
    # gene filtering
    cutoff: float = 1.0
    min_cells_per_gene: int = 3

    out_dir: Optional[str] = None

    # smoothing
    window_length: int = 101
    smooth_method: str = "pyramidinal"  # pyramidinal | runmeans | coordinates

    num_ref_groups: Optional[int] = None
    ref_subtract_use_mean_bounds: bool = True

    # clustering for plots
    cluster_by_groups: bool = True
    cluster_references: bool = True
    k_obs_groups: int = 1
    hclust_method: str = "ward.D2"

    max_centered_threshold: Union[float, str, None] = 3.0  # value | "auto" | None
    scale_data: bool = False

    # HMM
    HMM: bool = False
    HMM_transition_prob: float = 1e-6
    HMM_report_by: str = "subcluster"  # subcluster | consensus | cell
    HMM_type: str = "i6"               # i6 | i3
    HMM_i3_pval: float = 0.05
    HMM_i3_use_KS: bool = False
    BayesMaxPNormal: float = 0.5

    sim_method: str = "meanvar"
    sim_foreground: bool = False
    reassignCNVs: bool = True

    # subclustering
    analysis_mode: str = "subclusters"  # subclusters | samples | cells
    tumor_subcluster_partition_method: str = "leiden"
    tumor_subcluster_pval: float = 0.1
    k_nn: int = 20
    leiden_method: str = "PCA"
    leiden_function: str = "CPM"
    leiden_resolution: Union[float, str] = "auto"
    leiden_method_per_chr: str = "simple"
    leiden_function_per_chr: str = "modularity"
    leiden_resolution_per_chr: float = 1.0
    per_chr_hmm_subclusters: bool = False
    per_chr_hmm_subclusters_references: bool = False
    z_score_filter: float = 0.8

    # denoising
    denoise: bool = False
    noise_filter: Optional[float] = None
    sd_amplifier: float = 1.5
    noise_logistic: bool = False

    # outliers
    outlier_method_bound: str = "average_bound"
    outlier_lower_bound: Optional[float] = None
    outlier_upper_bound: Optional[float] = None

    # misc
    final_scale_limits: Union[None, str, Sequence[float]] = None
    final_center_val: Optional[float] = None
    debug: bool = False
    # accepted for API parity (reference sets a global thread count for
    # parallelDist/mclapply, inferCNV_constants.R:13-14); here the compiled
    # device programs own the parallelism and host BLAS threads are managed
    # by the runtime, so the value is intentionally not consumed
    num_threads: int = 4
    plot_steps: bool = False
    inspect_subclusters: bool = True
    resume_mode: bool = True
    png_res: int = 300
    plot_probabilities: bool = True
    save_rds: bool = True
    save_final_rds: bool = True
    diagnostics: bool = False

    # experimental
    remove_genes_at_chr_ends: bool = False
    prune_outliers: bool = False
    mask_nonDE_genes: bool = False
    mask_nonDE_pval: float = 0.05
    test_use: str = "wilcoxon"
    require_DE_all_normals: str = "any"

    hspike_aggregate_normals: bool = False
    # NB dispersion for sim_method='simple' hspike counts: 0.1 matches the
    # reference's live hardcode (inferCNV_hidden_spike.R:86,123); 'auto'
    # estimates it from the normal cells (edgeR::estimateDisp equivalent,
    # which the reference ships but never calls: inferCNV_simple_sim.R:227)
    hspike_common_dispersion: object = 0.1

    no_plot: bool = False
    no_prelim_plot: bool = False
    write_expr_matrix: bool = False
    write_phylo: bool = False
    output_format: str = "png"
    plot_chr_scale: bool = False
    chr_lengths: Optional[Sequence[int]] = None
    # fused engine fast path for steps 4-14: "auto" uses it whenever the
    # configuration is engine-expressible (see pipeline._engine_fast_ok);
    # True forces it (errors if incompatible); False always runs op-by-op
    use_engine: object = "auto"
    # plot cosmetics (reference plot_cnv args mirrored through the CLI)
    title: str = "inferCNV"
    title_obs: str = "Observations (Cells)"
    title_ref: str = "References (Cells)"
    contig_lab_size: int = 6
    color_safe: bool = False
    dynamic_resize: float = 0.0
    #: cells per engine streaming chunk (None = 16384); smaller values
    #: bound per-device HBM when a matrix exceeds one chip's budget
    engine_chunk_cells: Optional[int] = None
    #: reference plot_cnv(custom_color_pal): 3 colors for the heatmap ramp
    custom_color_pal: Optional[Sequence[str]] = None
    #: reference plot_cnv(ref_contig): cluster rows on these contigs only
    ref_contig: Optional[Union[str, Sequence[str]]] = None
    #: reference plot_cnv(hclust_method) for pane row ordering (the step-15
    #: subclustering hclust_method above is a separate knob, as in the
    #: reference)
    plot_hclust_method: str = "ward.D"
    useRaster: bool = True

    up_to_step: int = 100

    # framework-specific
    seed: int = 12345
    # scale-out: shard the engine's chunks and the step-17 Viterbi over a
    # 1-D cell-axis mesh (parallel/stats.CellMesh).  n_devices builds the
    # mesh from the run's device type; mesh accepts a prebuilt CellMesh.
    # Neither field takes part in checkpoint-resume matching.
    n_devices: Optional[int] = None
    mesh: object = None
    #: download dtype of the engine's residual chunks ("float16" halves the
    #: device->host bytes; values are ~fold-changes near 1.0, so the f16
    #: rounding is ~5e-4 relative — CNV calls are unaffected because the
    #: HMM/subcluster group sums accumulate in f32 on device).  None = f32.
    engine_transfer_dtype: Optional[str] = None
    #: back the [C, G] residual matrix with a disk memmap (under out_dir)
    #: when it would exceed this many GB of host RAM; None = always RAM.
    residual_memmap_gb: Optional[float] = None

    def validate(self) -> None:
        if self.smooth_method not in ("pyramidinal", "runmeans", "coordinates"):
            raise ValueError(f"unknown smooth_method {self.smooth_method!r}")
        if self.engine_transfer_dtype not in (None, "float32", "float16",
                                              "bfloat16"):
            raise ValueError(
                f"unknown engine_transfer_dtype {self.engine_transfer_dtype!r}"
                " (use None, 'float32', 'float16' or 'bfloat16')")
        if self.HMM_type not in ("i6", "i3"):
            raise ValueError(f"unknown HMM_type {self.HMM_type!r}")
        if self.analysis_mode not in ("subclusters", "samples", "cells"):
            raise ValueError(f"unknown analysis_mode {self.analysis_mode!r}")
        if self.HMM_report_by not in ("subcluster", "consensus", "cell"):
            raise ValueError(f"unknown HMM_report_by {self.HMM_report_by!r}")
        if self.HMM_type == "i6" and self.smooth_method == "coordinates":
            # reference forbids this combination (inferCNV_ops.R:353-356)
            raise ValueError("i6 HMM mode is incompatible with smooth_method='coordinates'")
        if self.smooth_method == "coordinates" and self.window_length < 10000:
            # reference remaps a gene-unit window to the 10 Mbp default
            # (inferCNV_ops.R:357-361)
            self.window_length = 10_000_000
        if self.tumor_subcluster_partition_method not in (
            "leiden", "random_trees", "qnorm", "pheight", "qgamma", "shc", "none",
        ):
            raise ValueError(
                f"unknown tumor_subcluster_partition_method {self.tumor_subcluster_partition_method!r}"
            )
