from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig, make_cell_mesh  # noqa: F401
from infercnv_tpu_torch.parallel.stats import (  # noqa: F401
    CellMesh,
    CellSharded,
    put_cell_sharded,
    sharded_group_gene_stats,
    sharded_median,
    sharded_quantile,
    to_host,
)
