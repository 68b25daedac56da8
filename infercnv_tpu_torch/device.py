"""Device selection: the port runs on CUDA unless told otherwise."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA device; it raises when CUDA is absent rather
    than falling back to the CPU.  ``"cpu"`` selects the plain PyTorch
    versions of every kernel (what the tests compare with the JAX package).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "infercnv_tpu_torch runs on a CUDA device by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
