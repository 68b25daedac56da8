"""Build the port's objects from plain numpy state.

A JAX engine's genome, HMM and configuration are plain fields (numpy arrays,
floats, strings); these helpers rebuild the port's counterparts from them, so
that a caller holding the reference's state (a test, a checkpoint) can hand it
across without either package importing the other.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from infercnv_tpu_torch.core.genome import GeneOrder
from infercnv_tpu_torch.device import DeviceLike, resolve_device
from infercnv_tpu_torch.models.hmm import HMMParams
from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig


def engine_from_numpy(gene_order: Mapping, hmm: Mapping,
                      config: Optional[Mapping] = None,
                      device: DeviceLike = None) -> CnvEngine:
    """CnvEngine from plain fields.

    gene_order: names, chr_names, chr_ids, start, stop (the GeneOrder fields);
    hmm: means, sds, t; config: any EngineConfig fields (others default)."""
    go = GeneOrder(names=tuple(gene_order["names"]),
                   chr_names=tuple(gene_order["chr_names"]),
                   chr_ids=np.asarray(gene_order["chr_ids"]),
                   start=np.asarray(gene_order["start"]),
                   stop=np.asarray(gene_order["stop"]))
    params = HMMParams(means=np.asarray(hmm["means"], np.float64),
                       sds=np.asarray(hmm["sds"], np.float64),
                       t=float(hmm["t"]))
    return CnvEngine(go, params, EngineConfig(**dict(config or {})), device=device)


def ref_stats_from_numpy(ref_means_log, ref_means_resid, noise_bounds,
                         device: DeviceLike = None):
    """Reference statistics (as returned by a ref_stats call, here numpy
    arrays) as float32 tensors on the port's device, ready for the chunk
    entry points."""
    dev = resolve_device(device)
    return tuple(torch.tensor(np.asarray(a, np.float32)).to(dev)
                 for a in (ref_means_log, ref_means_resid, noise_bounds))
