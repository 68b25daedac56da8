from infercnv_tpu_torch.io.loaders import (  # noqa: F401
    load_bundled_example,
    load_infercnv_object,
    load_r_golden_example,
    read_annotations_file,
    read_counts_matrix,
    read_gene_order_file,
    read_h5ad_counts,
    read_mtx,
)
