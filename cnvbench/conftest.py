"""pytest settings of the benchmark's own tests (cnvbench/tests).

Tests that need an NVIDIA GPU carry the ``chip`` marker and take the
``cuda_device`` fixture, which skips them where there is none; the decision
is made when the fixture runs, never while a module is imported.  Run them
on the card with ``python -m pytest cnvbench/tests -m chip``.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA GPU (CUDA)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
