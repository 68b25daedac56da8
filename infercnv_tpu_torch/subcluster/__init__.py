from infercnv_tpu_torch.subcluster.distance import (  # noqa: F401
    condensed_dists,
    knn_indices,
    pairwise_dists,
    pairwise_sq_dists,
)
from infercnv_tpu_torch.subcluster.leiden import auto_resolution, knn_graph, leiden, snn_graph  # noqa: F401
from infercnv_tpu_torch.subcluster.partition import define_tumor_subclusters, ward_linkage  # noqa: F401
from infercnv_tpu_torch.subcluster.pca import pca_embed  # noqa: F401
