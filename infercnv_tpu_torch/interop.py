"""Build the port's objects from plain numpy state.

A JAX engine's genome, HMM and configuration, and an InferCNV object, are
plain fields (numpy arrays, floats, strings, dicts); these helpers rebuild
the port's counterparts from them, so that a caller holding the reference's
state (a test, a checkpoint) can hand it across without either package
importing the other.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from infercnv_tpu_torch.core.genome import GeneOrder
from infercnv_tpu_torch.core.object import InferCNV
from infercnv_tpu_torch.device import DeviceLike, resolve_device
from infercnv_tpu_torch.models.hmm import HMMParams
from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig


def gene_order_from_numpy(fields: Mapping) -> GeneOrder:
    """GeneOrder from its fields: names, chr_names, chr_ids, start, stop."""
    return GeneOrder(names=tuple(fields["names"]),
                     chr_names=tuple(fields["chr_names"]),
                     chr_ids=np.asarray(fields["chr_ids"]),
                     start=np.asarray(fields["start"]),
                     stop=np.asarray(fields["stop"]))


def hmm_params_from_numpy(fields: Mapping) -> HMMParams:
    """HMMParams from its fields: means, sds, t."""
    return HMMParams(means=np.asarray(fields["means"], np.float64),
                     sds=np.asarray(fields["sds"], np.float64),
                     t=float(fields["t"]))


def trend_fits_from_numpy(fits: Mapping) -> Dict[str, Tuple[float, float]]:
    """The hspike's cell-count trend fits, {level: (intercept, slope)}."""
    return {str(k): (float(v[0]), float(v[1])) for k, v in fits.items()}


def _groups(groups: Mapping) -> Dict[str, np.ndarray]:
    return {str(k): np.asarray(v).copy() for k, v in groups.items()}


def _subclusters(ts: Optional[Mapping]) -> Optional[dict]:
    """tumor_subclusters {"hc": {group: linkage or None}, "subclusters":
    {group: {name: indices}}} as numpy copies."""
    if ts is None:
        return None
    return {"hc": {str(g): (None if z is None else np.asarray(z).copy())
                   for g, z in ts["hc"].items()},
            "subclusters": {str(g): _groups(subs)
                            for g, subs in ts["subclusters"].items()}}


def infercnv_from_numpy(fields: Mapping) -> InferCNV:
    """The port's InferCNV from a reference object's plain fields: expr,
    counts (or None), gene_order (a mapping of its fields, or an object
    with them as attributes), cell_names, ref_groups, obs_groups, options,
    and optionally tumor_subclusters and hspike (the same fields, taken
    recursively).  Arrays are copied."""
    go = fields["gene_order"]
    if not isinstance(go, Mapping):
        go = {k: getattr(go, k) for k in ("names", "chr_names", "chr_ids",
                                          "start", "stop")}
    hs = fields.get("hspike")
    if hs is not None and not isinstance(hs, Mapping):
        hs = vars(hs)
    counts = fields.get("counts")
    return InferCNV(
        expr=np.array(fields["expr"], np.float32),
        counts=None if counts is None else np.array(counts),
        gene_order=gene_order_from_numpy(go),
        cell_names=[str(c) for c in fields["cell_names"]],
        ref_groups=_groups(fields["ref_groups"]),
        obs_groups=_groups(fields["obs_groups"]),
        tumor_subclusters=_subclusters(fields.get("tumor_subclusters")),
        hspike=None if hs is None else infercnv_from_numpy(hs),
        options=dict(fields.get("options") or {}),
    )


def engine_from_numpy(gene_order: Mapping, hmm: Mapping,
                      config: Optional[Mapping] = None,
                      device: DeviceLike = None) -> CnvEngine:
    """CnvEngine from plain fields.

    gene_order: names, chr_names, chr_ids, start, stop (the GeneOrder fields);
    hmm: means, sds, t; config: any EngineConfig fields (others default)."""
    return CnvEngine(gene_order_from_numpy(gene_order),
                     hmm_params_from_numpy(hmm),
                     EngineConfig(**dict(config or {})), device=device)


def ref_stats_from_numpy(ref_means_log, ref_means_resid, noise_bounds,
                         device: DeviceLike = None):
    """Reference statistics (as returned by a ref_stats call, here numpy
    arrays) as float32 tensors on the port's device, ready for the chunk
    entry points."""
    dev = resolve_device(device)
    return tuple(torch.tensor(np.asarray(a, np.float32)).to(dev)
                 for a in (ref_means_log, ref_means_resid, noise_bounds))
