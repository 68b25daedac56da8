"""Command-line interface mirroring the reference CLI
(reference scripts/inferCNV.R:182-1142 — optparse flags 1:1 with run()).

Copied from infercnv_tpu/cli.py (``build_parser`` with every flag, and
``main``), with one flag more: ``--device`` (the CUDA device by default;
``cpu`` runs the plain PyTorch versions), which goes to run(), the median
filter and its heatmap.  It stands where the reference reads JAX_PLATFORMS.

Usage:
    python -m infercnv_tpu_torch.cli --raw_counts_matrix counts.tsv.gz \
        --annotations_file annots.txt --gene_order_file genes.txt \
        --ref_group_names "Microglia/Macrophage,Oligodendrocytes (non-malignant)" \
        --out_dir out --cutoff 1 --HMM --denoise
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="infercnv_tpu_torch",
        description="inferCNV on CUDA: infer copy-number variation from scRNA-seq",
    )
    # inputs
    p.add_argument("--raw_counts_matrix", required=True)
    p.add_argument("--annotations_file", required=True)
    p.add_argument("--gene_order_file", required=True)
    p.add_argument("--ref_group_names", default="",
                   help="comma-separated reference group names")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--delim", default="\t")
    p.add_argument("--max_cells_per_group", type=int, default=None)
    p.add_argument("--chr_exclude", default="chrX,chrY,chrM")

    # gene filtering
    p.add_argument("--cutoff", type=float, default=1.0)
    p.add_argument("--min_cells_per_gene", type=int, default=3)

    # smoothing
    p.add_argument("--window_length", type=int, default=101)
    p.add_argument("--smooth_method", default="pyramidinal",
                   choices=["pyramidinal", "runmeans", "coordinates"])

    p.add_argument("--num_ref_groups", type=int, default=None)
    p.add_argument("--no_ref_subtract_use_mean_bounds", action="store_true")

    # clustering
    # reference CLI default is FALSE (scripts/inferCNV.R:255-262) even
    # though run()'s own default is TRUE — mirror the CLI
    p.add_argument("--cluster_by_groups", action="store_true", default=False)
    p.add_argument("--no_cluster_by_groups", dest="cluster_by_groups", action="store_false")
    p.add_argument("--no_cluster_references", action="store_true")
    p.add_argument("--k_obs_groups", type=int, default=1)
    p.add_argument("--hclust_method", default="ward.D2")

    p.add_argument("--max_centered_threshold", default="3")
    p.add_argument("--scale_data", action="store_true")

    # HMM
    p.add_argument("--HMM", action="store_true")
    p.add_argument("--HMM_transition_prob", type=float, default=1e-6)
    p.add_argument("--HMM_report_by", default="subcluster",
                   choices=["subcluster", "consensus", "cell"])
    p.add_argument("--HMM_type", default="i6", choices=["i6", "i3"])
    p.add_argument("--HMM_i3_pval", type=float, default=0.05)
    p.add_argument("--HMM_i3_use_KS", action="store_true")
    p.add_argument("--BayesMaxPNormal", type=float, default=0.5)
    p.add_argument("--no_reassignCNVs", action="store_true")
    p.add_argument("--sim_method", default="meanvar")
    p.add_argument("--sim_foreground", action="store_true")

    # subclustering
    p.add_argument("--analysis_mode", default="subclusters",
                   choices=["subclusters", "samples", "cells"])
    p.add_argument("--tumor_subcluster_partition_method", default="leiden")
    p.add_argument("--tumor_subcluster_pval", type=float, default=0.1)
    p.add_argument("--k_nn", type=int, default=20)
    p.add_argument("--leiden_method", default="PCA", choices=["PCA", "simple"])
    p.add_argument("--leiden_function", default="CPM", choices=["CPM", "modularity"])
    p.add_argument("--leiden_resolution", default="auto")
    p.add_argument("--leiden_method_per_chr", default="simple")
    p.add_argument("--leiden_function_per_chr", default="modularity")
    p.add_argument("--leiden_resolution_per_chr", type=float, default=1.0)
    p.add_argument("--per_chr_hmm_subclusters", action="store_true")
    p.add_argument("--per_chr_hmm_subclusters_references", action="store_true")
    p.add_argument("--z_score_filter", type=float, default=0.8)

    # denoising
    p.add_argument("--denoise", action="store_true")
    p.add_argument("--noise_filter", type=float, default=None)
    p.add_argument("--sd_amplifier", type=float, default=1.5)
    p.add_argument("--noise_logistic", action="store_true")

    # outliers
    p.add_argument("--outlier_method_bound", default="average_bound")
    p.add_argument("--outlier_lower_bound", type=float, default=None)
    p.add_argument("--outlier_upper_bound", type=float, default=None)
    p.add_argument("--prune_outliers", action="store_true")

    # misc
    p.add_argument("--final_scale_limits", default=None)
    p.add_argument("--final_center_val", type=float, default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--num_threads", type=int, default=4)
    p.add_argument("--plot_steps", action="store_true")
    p.add_argument("--no_inspect_subclusters", action="store_true")
    p.add_argument("--no_resume_mode", action="store_true")
    p.add_argument("--png_res", type=int, default=300)
    p.add_argument("--no_plot_probabilities", action="store_true")
    p.add_argument("--no_save_rds", action="store_true")
    p.add_argument("--no_save_final_rds", action="store_true")
    p.add_argument("--diagnostics", action="store_true")
    p.add_argument("--remove_genes_at_chr_ends", action="store_true")
    p.add_argument("--mask_nonDE_genes", action="store_true")
    p.add_argument("--mask_nonDE_pval", type=float, default=0.05)
    p.add_argument("--test_use", default="wilcoxon", choices=["wilcoxon", "t", "perm"])
    p.add_argument("--require_DE_all_normals", default="any")
    p.add_argument("--hspike_aggregate_normals", action="store_true")
    p.add_argument("--no_plot", action="store_true")
    p.add_argument("--no_prelim_plot", action="store_true")
    p.add_argument("--write_expr_matrix", action="store_true")
    p.add_argument("--write_phylo", action="store_true")
    p.add_argument("--output_format", default="png")
    p.add_argument("--plot_chr_scale", action="store_true")
    p.add_argument("--up_to_step", type=int, default=100)
    p.add_argument("--use_engine", default="auto", choices=["auto", "true", "false"],
                   help="fused-engine fast path for steps 4-14 (default auto)")
    p.add_argument("--n_devices", type=int, default=None,
                   help="shard the engine and the HMM over a cell-axis mesh "
                        "of this many devices (default: single device)")
    p.add_argument("--device", default=None,
                   help="the device to run on (default: the CUDA device; "
                        "'cpu' runs the plain PyTorch versions)")
    p.add_argument("--log_file", default=None)
    p.add_argument("--seed", type=int, default=12345)

    # plot cosmetics (reference CLI)
    p.add_argument("--title", default="inferCNV")
    p.add_argument("--title_obs", default="Observations (Cells)")
    p.add_argument("--title_ref", default="References (Cells)")
    p.add_argument("--contig_lab_size", type=int, default=6)
    p.add_argument("--color_safe", action="store_true")
    p.add_argument("--dynamic_resize", type=float, default=0)
    p.add_argument("--custom_color_pal", default=None,
                   help="comma-separated low,mid,high colors for the heatmap "
                        "ramp (reference plot_cnv custom_color_pal)")
    p.add_argument("--ref_contig", default=None,
                   help="cluster heatmap rows on this contig's genes only "
                        "(reference plot_cnv ref_contig; comma-separated "
                        "for several)")
    p.add_argument("--plot_hclust_method", default="ward.D",
                   choices=sorted({"ward.D", "ward.D2", "complete", "average",
                                   "single", "centroid", "median", "mcquitty"}),
                   help="linkage method for heatmap row ordering "
                        "(reference plot_cnv hclust_method)")

    # NGCHM interactive heatmaps are an R/Java ecosystem feature; accepted
    # for flag parity but not implemented here
    p.add_argument("--ngchm", action="store_true")
    p.add_argument("--path_to_shaidyMapGen", default=None)
    p.add_argument("--gene_symbol", default=None)

    # post-run extras (reference CLI tail: median filter + seurat metadata)
    p.add_argument("--median_filter", action="store_true")
    p.add_argument("--top_n", type=int, default=10,
                   help="top-N largest CNVs for metadata export")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np

    if args.log_file:
        from infercnv_tpu_torch.utils.logging import set_log_file

        set_log_file(args.log_file)

    from infercnv_tpu_torch.io import load_infercnv_object
    from infercnv_tpu_torch.runner.pipeline import run

    mct = args.max_centered_threshold
    if mct not in (None, "auto"):
        try:
            mct = float(mct)
        except ValueError:
            pass
    if isinstance(mct, str) and mct.lower() in ("na", "none"):
        mct = None

    leiden_res = args.leiden_resolution
    if leiden_res != "auto":
        leiden_res = float(leiden_res)

    obj = load_infercnv_object(
        counts_path=args.raw_counts_matrix,
        gene_order_path=args.gene_order_file,
        annotations_path=args.annotations_file,
        ref_group_names=[g for g in args.ref_group_names.split(",") if g],
        chr_exclude=tuple(c for c in args.chr_exclude.split(",") if c),
        max_cells_per_group=args.max_cells_per_group,
        sep=args.delim,
    )
    res = run(
        obj,
        out_dir=args.out_dir,
        device=args.device,
        cutoff=args.cutoff,
        min_cells_per_gene=args.min_cells_per_gene,
        window_length=args.window_length,
        smooth_method=args.smooth_method,
        num_ref_groups=args.num_ref_groups,
        ref_subtract_use_mean_bounds=not args.no_ref_subtract_use_mean_bounds,
        cluster_by_groups=args.cluster_by_groups,
        plot_probabilities=not args.no_plot_probabilities,
        final_scale_limits=(
            None if not args.final_scale_limits
            else ("auto" if args.final_scale_limits == "auto"
                  else tuple(float(v)
                             for v in args.final_scale_limits.split(",")))),
        cluster_references=not args.no_cluster_references,
        k_obs_groups=args.k_obs_groups,
        hclust_method=args.hclust_method,
        max_centered_threshold=mct,
        scale_data=args.scale_data,
        HMM=args.HMM,
        HMM_transition_prob=args.HMM_transition_prob,
        HMM_report_by=args.HMM_report_by,
        HMM_type=args.HMM_type,
        HMM_i3_pval=args.HMM_i3_pval,
        HMM_i3_use_KS=args.HMM_i3_use_KS,
        BayesMaxPNormal=args.BayesMaxPNormal,
        reassignCNVs=not args.no_reassignCNVs,
        sim_method=args.sim_method,
        sim_foreground=args.sim_foreground,
        analysis_mode=args.analysis_mode,
        tumor_subcluster_partition_method=args.tumor_subcluster_partition_method,
        tumor_subcluster_pval=args.tumor_subcluster_pval,
        k_nn=args.k_nn,
        leiden_method=args.leiden_method,
        leiden_function=args.leiden_function,
        leiden_resolution=leiden_res,
        leiden_method_per_chr=args.leiden_method_per_chr,
        leiden_function_per_chr=args.leiden_function_per_chr,
        leiden_resolution_per_chr=args.leiden_resolution_per_chr,
        per_chr_hmm_subclusters=args.per_chr_hmm_subclusters,
        per_chr_hmm_subclusters_references=args.per_chr_hmm_subclusters_references,
        z_score_filter=args.z_score_filter,
        denoise=args.denoise,
        noise_filter=args.noise_filter,
        sd_amplifier=args.sd_amplifier,
        noise_logistic=args.noise_logistic,
        outlier_method_bound=args.outlier_method_bound,
        outlier_lower_bound=args.outlier_lower_bound,
        outlier_upper_bound=args.outlier_upper_bound,
        prune_outliers=args.prune_outliers,
        final_center_val=args.final_center_val,
        debug=args.debug,
        plot_steps=args.plot_steps,
        inspect_subclusters=not args.no_inspect_subclusters,
        resume_mode=not args.no_resume_mode,
        png_res=args.png_res,
        save_rds=not args.no_save_rds,
        save_final_rds=not args.no_save_final_rds,
        diagnostics=args.diagnostics,
        remove_genes_at_chr_ends=args.remove_genes_at_chr_ends,
        mask_nonDE_genes=args.mask_nonDE_genes,
        mask_nonDE_pval=args.mask_nonDE_pval,
        test_use=args.test_use,
        require_DE_all_normals=args.require_DE_all_normals,
        hspike_aggregate_normals=args.hspike_aggregate_normals,
        no_plot=args.no_plot,
        no_prelim_plot=args.no_prelim_plot,
        write_expr_matrix=args.write_expr_matrix,
        write_phylo=args.write_phylo,
        output_format=args.output_format,
        plot_chr_scale=args.plot_chr_scale,
        up_to_step=args.up_to_step,
        use_engine={"auto": "auto", "true": True, "false": False}[args.use_engine],
        n_devices=args.n_devices,
        seed=args.seed,
        title=args.title,
        title_obs=args.title_obs,
        title_ref=args.title_ref,
        contig_lab_size=args.contig_lab_size,
        color_safe=args.color_safe,
        custom_color_pal=(args.custom_color_pal.split(",")
                          if args.custom_color_pal else None),
        ref_contig=(args.ref_contig.split(",") if args.ref_contig else None),
        plot_hclust_method=args.plot_hclust_method,
        dynamic_resize=args.dynamic_resize,
    )

    if args.ngchm:
        from infercnv_tpu_torch.utils.logging import log_warn

        log_warn("--ngchm requested: NGCHM output (Java shaidyMapGen) is not "
                 "supported in infercnv_tpu; standard heatmaps were written")

    final_obj = res.infercnv_obj
    if args.median_filter and final_obj is not None:
        from infercnv_tpu_torch.ops.median_filter import apply_median_filtering
        from infercnv_tpu_torch.viz.heatmap import plot_cnv

        apply_median_filtering(final_obj, device=args.device)
        if not args.no_plot:
            plot_cnv(final_obj, out_dir=args.out_dir,
                     output_filename="infercnv.median_filtered",
                     title="inferCNV (median filtered)",
                     x_center=1.0, x_range="auto",
                     png_res=args.png_res,
                     color_safe_pal=args.color_safe,
                     custom_color_pal=(args.custom_color_pal.split(",")
                                       if args.custom_color_pal else None),
                     contig_lab_size=args.contig_lab_size,
                     dynamic_resize=args.dynamic_resize,
                     plot_chr_scale=args.plot_chr_scale,
                     hclust_method=args.plot_hclust_method,
                     output_format=args.output_format,
                     device=args.device)

    if args.HMM and res.region_reports is not None and final_obj is not None:
        from infercnv_tpu_torch.report.seurat_export import add_to_metadata

        add_to_metadata(final_obj, res.region_reports, args.out_dir,
                        hmm_type=args.HMM_type, top_n=args.top_n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
