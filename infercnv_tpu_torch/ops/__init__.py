from infercnv_tpu_torch.ops import layout, smoothing, transforms  # noqa: F401
