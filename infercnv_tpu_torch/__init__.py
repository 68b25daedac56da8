"""infercnv_tpu_torch: the PyTorch/CUDA port of infercnv_tpu for NVIDIA Hopper.

The JAX package ``infercnv_tpu`` is the reference; this package does the same
work in PyTorch, with each of its TPU kernels rewritten by hand in CUDA C++
for ``sm_90a`` (sources under ``csrc/``, built with nvcc at first use into
``build/infercnv_tpu_torch/``).  It imports neither JAX nor ``infercnv_tpu``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version instead.

Ported so far: the streaming engine
(:class:`infercnv_tpu_torch.parallel.engine.CnvEngine`: reference
statistics, residual chunks, subcluster sums and the group-mean Viterbi),
the ``InferCNV`` object and its loaders, and ``runner.pipeline.run`` (steps
4-14 on the engine or op by op, the hspike, every step-15 partition with
the default Leiden from the residual kept on the card, the i6/i3 HMM, the
region reports, the non-DE mask, the Bayes filter, the checkpoints and
every plot, each heatmap's data side on the device); ``run`` refuses the
options whose modules are not ported yet (the mesh, splatter).  The
Leiden is the reference's C++ (``native/``), built with g++ at first use
into the same directory.
"""

from infercnv_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
__version__ = "0.1.0"
