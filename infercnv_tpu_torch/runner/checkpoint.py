"""Step checkpoint/resume system.

Copied from infercnv_tpu/runner/checkpoint.py (all of it, 275 lines), which
is plain numpy, on the port's ``InferCNV`` and ``GeneOrder``.  The ``.npz``
files are the JAX package's: either package loads the other's.

reference: run()'s per-step saveRDS with deterministic file names plus the
relevant-args registry (.get_relevant_args_list R/inferCNV_ops.R:3289-3497)
and resume scan (:449-529, .compare_args :3270-3282).

Here each step saves a ``.npz`` (arrays) + embedded JSON metadata (relevant
args for steps 1..i, counts fingerprint, group structure).  On resume the
newest step whose stored args match the current config is reloaded.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from infercnv_tpu_torch.core.genome import GeneOrder
from infercnv_tpu_torch.core.object import InferCNV
from infercnv_tpu_torch.utils.logging import log_info


def relevant_args_by_step(cfg) -> List[Dict]:
    """Relevant-arg sets per step index (1-based), cumulative semantics as
    in the reference registry (inferCNV_ops.R:3289-3497)."""
    steps = {
        1: {},
        2: {"cutoff": cfg.cutoff, "min_cells_per_gene": cfg.min_cells_per_gene},
        3: {"HMM": cfg.HMM, "HMM_type": cfg.HMM_type, "sim_method": cfg.sim_method,
            "sim_foreground": cfg.sim_foreground,
            "hspike_aggregate_normals": cfg.hspike_aggregate_normals,
            "hspike_common_dispersion": cfg.hspike_common_dispersion,
            "seed": cfg.seed},
        4: {},
        5: {"scale_data": cfg.scale_data},
        6: {"num_ref_groups": cfg.num_ref_groups, "hclust_method": cfg.hclust_method},
        7: {"analysis_mode": cfg.analysis_mode,
            "tumor_subcluster_partition_method": cfg.tumor_subcluster_partition_method,
            "tumor_subcluster_pval": cfg.tumor_subcluster_pval},
        8: {"ref_subtract_use_mean_bounds": cfg.ref_subtract_use_mean_bounds},
        9: {"max_centered_threshold": cfg.max_centered_threshold},
        10: {"smooth_method": cfg.smooth_method, "window_length": cfg.window_length},
        11: {},
        12: {},
        13: {"remove_genes_at_chr_ends": cfg.remove_genes_at_chr_ends},
        14: {},
        15: {"analysis_mode": cfg.analysis_mode, "k_nn": cfg.k_nn,
             "leiden_method": cfg.leiden_method, "leiden_function": cfg.leiden_function,
             "leiden_resolution": cfg.leiden_resolution,
             "cluster_by_groups": cfg.cluster_by_groups,
             "per_chr_hmm_subclusters": cfg.per_chr_hmm_subclusters,
             "z_score_filter": cfg.z_score_filter},
        16: {"prune_outliers": cfg.prune_outliers,
             "outlier_method_bound": cfg.outlier_method_bound,
             "outlier_lower_bound": cfg.outlier_lower_bound,
             "outlier_upper_bound": cfg.outlier_upper_bound},
        17: {"HMM": cfg.HMM, "HMM_transition_prob": cfg.HMM_transition_prob,
             "HMM_report_by": cfg.HMM_report_by, "HMM_i3_pval": cfg.HMM_i3_pval,
             "HMM_i3_use_KS": cfg.HMM_i3_use_KS},
        18: {"BayesMaxPNormal": cfg.BayesMaxPNormal},
        19: {"reassignCNVs": cfg.reassignCNVs},
        20: {},
        21: {"mask_nonDE_genes": cfg.mask_nonDE_genes,
             "mask_nonDE_pval": cfg.mask_nonDE_pval, "test_use": cfg.test_use,
             "require_DE_all_normals": cfg.require_DE_all_normals},
        22: {"denoise": cfg.denoise, "noise_filter": cfg.noise_filter,
             "sd_amplifier": cfg.sd_amplifier, "noise_logistic": cfg.noise_logistic},
        23: {},
    }
    cum: List[Dict] = []
    acc: Dict = {}
    for i in range(1, 24):
        acc = {**acc, **{f"s{i}.{k}": v for k, v in steps[i].items()}}
        cum.append(dict(acc))
    return cum


STEP_TOKENS = {
    1: "incoming_data", 2: "reduced_by_cutoff", 3: "normalized_by_depth",
    4: "logtransformed", 5: "scaled", 6: "split_refs",
    7: "tumor_subclusters.random_trees", 8: "remove_ref_avg_from_obs_logFC",
    9: "apply_max_centered_expr_threshold", 10: "smoothed_by_chr",
    11: "recentered_cells_by_chr", 12: "remove_ref_avg_from_obs_adjust",
    13: "remove_gene_at_chr_ends", 14: "invert_log_transform",
    15: "tumor_subclusters", 16: "removed_outliers", 17: "HMM_pred",
    18: "HMM_pred.Bayes_Net", 19: "HMM_pred.repr_intensitiesfiltered",
    20: "HMM_pred.repr_intensities", 21: "mask_nonDE",
    22: "denoised", 23: "final",
}


def step_filename(step: int, resume_token: str) -> str:
    return f"{step:02d}_{STEP_TOKENS[step]}{resume_token}.infercnv_obj.npz"


def _groups_to_json(groups: Dict[str, np.ndarray]) -> Dict[str, List[int]]:
    return {k: np.asarray(v).tolist() for k, v in groups.items()}


def _groups_from_json(d) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v, np.int64) for k, v in d.items()}


def save_step(obj: InferCNV, path: str, relevant_args: Dict,
              states: Optional[np.ndarray] = None) -> None:
    go = obj.gene_order
    meta = {
        "relevant_args": dict(relevant_args),
        "cell_names": obj.cell_names,
        "ref_groups": _groups_to_json(obj.ref_groups),
        "obs_groups": _groups_to_json(obj.obs_groups),
        "gene_names": list(go.names),
        "chr_names": list(go.chr_names),
        "counts_md5": obj.options.get("counts_md5"),
        "options": {k: (list(v) if isinstance(v, tuple) else v)
                    for k, v in obj.options.items()
                    if isinstance(v, (str, int, float, bool, tuple, list, type(None)))},
        "subclusters": (
            {g: _groups_to_json(s) for g, s in obj.tumor_subclusters["subclusters"].items()}
            if obj.tumor_subclusters else None
        ),
        "hc_groups": (
            [g for g, link in obj.tumor_subclusters.get("hc", {}).items()
             if link is not None]
            if obj.tumor_subclusters else []
        ),
    }
    arrays = {
        "expr": obj.expr,
        "counts": obj.counts,
        "chr_ids": go.chr_ids,
        "start": go.start,
        "stop": go.stop,
    }
    for i, g in enumerate(meta["hc_groups"]):
        arrays[f"hc_{i}"] = np.asarray(obj.tumor_subclusters["hc"][g])
    if states is not None:
        arrays["states"] = states
    if obj.hspike is not None:
        h = obj.hspike
        hg = h.gene_order
        meta["hspike"] = {
            "cell_names": h.cell_names,
            "ref_groups": _groups_to_json(h.ref_groups),
            "obs_groups": _groups_to_json(h.obs_groups),
            "gene_names": list(hg.names),
            "chr_names": list(hg.chr_names),
        }
        arrays["hspike_expr"] = h.expr
        arrays["hspike_chr_ids"] = hg.chr_ids
        arrays["hspike_start"] = hg.start
        arrays["hspike_stop"] = hg.stop
    np.savez_compressed(path + ".tmp.npz", meta=json.dumps(meta), **arrays)
    os.replace(path + ".tmp.npz", path)


def load_step(path: str) -> Tuple[InferCNV, Dict, Optional[np.ndarray]]:
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    go = GeneOrder(
        names=tuple(meta["gene_names"]),
        chr_names=tuple(meta["chr_names"]),
        chr_ids=z["chr_ids"], start=z["start"], stop=z["stop"],
    )
    options = dict(meta.get("options") or {})
    options.setdefault("counts_md5", meta.get("counts_md5"))
    obj = InferCNV(
        expr=z["expr"],
        counts=z["counts"] if "counts" in z.files else z["expr"],
        gene_order=go,
        cell_names=list(meta["cell_names"]),
        ref_groups=_groups_from_json(meta["ref_groups"]),
        obs_groups=_groups_from_json(meta["obs_groups"]),
        options=options,
    )
    if meta.get("subclusters") is not None:  # {} still carries hc trees
        hc = {g: z[f"hc_{i}"] for i, g in enumerate(meta.get("hc_groups") or [])
              if f"hc_{i}" in z.files}
        obj.tumor_subclusters = {
            "subclusters": {g: _groups_from_json(s) for g, s in meta["subclusters"].items()},
            "hc": hc,
        }
    if meta.get("hspike") and "hspike_expr" in z.files:
        hm = meta["hspike"]
        hgo = GeneOrder(
            names=tuple(hm["gene_names"]), chr_names=tuple(hm["chr_names"]),
            chr_ids=z["hspike_chr_ids"], start=z["hspike_start"], stop=z["hspike_stop"],
        )
        obj.hspike = InferCNV(
            expr=z["hspike_expr"], counts=z["hspike_expr"], gene_order=hgo,
            cell_names=list(hm["cell_names"]),
            ref_groups=_groups_from_json(hm["ref_groups"]),
            obs_groups=_groups_from_json(hm["obs_groups"]),
        )
    states = z["states"] if "states" in z.files else None
    return obj, meta["relevant_args"], states


def _json_eq(a, b) -> bool:
    return json.dumps(a, sort_keys=True, default=str) == json.dumps(b, sort_keys=True, default=str)


def _peek_meta(path: str):
    """Read ONLY the embedded JSON metadata of a step checkpoint — npz
    members decompress lazily, so validating a candidate costs kilobytes
    instead of materializing multi-GB expr/counts payloads."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["meta"]))


def _candidate_matches(path: str, cum_args: Dict, counts_md5) -> bool:
    """Cheap arg/md5 validation from the metadata alone; logs (instead of
    silently skipping) when a checkpoint file cannot be read."""
    try:
        meta = _peek_meta(path)
    except Exception as e:
        log_info(f"resume: checkpoint {path} unreadable ({e}); skipping")
        return False
    saved_md5 = (meta.get("options") or {}).get("counts_md5") or meta.get("counts_md5")
    if counts_md5 and saved_md5 and saved_md5 != counts_md5:
        log_info(f"resume: checkpoint {path} was built from different "
                 "input counts (md5 mismatch); recomputing")
        return False
    return _json_eq(meta["relevant_args"], cum_args)


def scan_hmm_states(out_dir: str, cfg, resume_token: str,
                    counts_md5: Optional[str]) -> Tuple[int, Optional[np.ndarray]]:
    """Reload the HMM chain's state matrix from the step-19 (post-Bayes) or
    step-17 (raw Viterbi) checkpoint, newest-first, with the same arg/md5
    validation as scan_resume (reference special-cases the 17->20 chain,
    inferCNV_ops.R:459-529).  Returns (step, states) or (0, None)."""
    cum_args = relevant_args_by_step(cfg)
    for step in (19, 17):
        path = os.path.join(out_dir, step_filename(step, resume_token))
        if not os.path.exists(path):
            continue
        if not _candidate_matches(path, cum_args[step - 1], counts_md5):
            continue
        try:
            _obj, _saved_args, states = load_step(path)
        except Exception as e:
            log_info(f"resume: checkpoint {path} failed to load ({e}); skipping")
            continue
        if states is None:
            continue
        log_info(f"resume: reusing HMM states from step {step}: {path}")
        return step, np.asarray(states)
    return 0, None


def scan_resume(out_dir: str, cfg, resume_token: str, counts_md5: Optional[str],
                max_step: int = 23):
    """Find the newest reusable step checkpoint.  Returns (step, obj, states)
    or (0, None, None)."""
    cum_args = relevant_args_by_step(cfg)
    for step in range(max_step, 0, -1):
        path = os.path.join(out_dir, step_filename(step, resume_token))
        if not os.path.exists(path):
            continue
        # validate from metadata alone before touching the (multi-GB at
        # scale) array payloads — rejected candidates cost kilobytes
        if not _candidate_matches(path, cum_args[step - 1], counts_md5):
            continue
        try:
            obj, _saved_args, states = load_step(path)
        except Exception as e:
            log_info(f"resume: checkpoint {path} failed to load ({e}); skipping")
            continue
        log_info(f"resume: reusing checkpoint for step {step}: {path}")
        return step, obj, states
    return 0, None, None
