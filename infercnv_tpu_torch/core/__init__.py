from infercnv_tpu_torch.core.genome import GeneOrder, order_reduce  # noqa: F401
from infercnv_tpu_torch.core.object import InferCNV, create_infercnv_object  # noqa: F401
