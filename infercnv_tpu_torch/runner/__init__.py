from infercnv_tpu_torch.runner.config import RunConfig  # noqa: F401
from infercnv_tpu_torch.runner.pipeline import RunResult, run  # noqa: F401
