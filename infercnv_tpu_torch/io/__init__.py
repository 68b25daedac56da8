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
from infercnv_tpu_torch.io.rds import (  # noqa: F401
    read_rda,
    read_rds,
    read_rds_infercnv,
    save_rds_infercnv,
    write_rds,
    write_rds_matrix,
)
from infercnv_tpu_torch.io.sharded import (  # noqa: F401
    global_cell_array,
    host_cell_slice,
    load_counts_shard,
)
