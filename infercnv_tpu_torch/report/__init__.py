from infercnv_tpu_torch.report.regions import (  # noqa: F401
    CnvRegion,
    GroupRegions,
    define_cnv_gene_regions,
    generate_cnv_region_reports,
    get_predicted_cnv_regions,
    state_consensus,
    write_expr_matrix,
)
