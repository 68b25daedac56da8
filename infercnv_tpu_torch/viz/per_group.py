"""Per-group plotting and cell sampling.

reference: R/infercnv_sampling.R — sample_object (:52-426) resamples every
group to a target size (downsampling by random choice / 1-in-every_n along
the dendrogram, or UPsampling by duplicating cells with ``_k`` renames and
zero-height tree grafts), and plot_per_group (:505-661) splits the object
per annotation group and renders one heatmap per group on a common color
scale.

Design deltas from the reference (intentional):

* The reference flattens each sampled group's subclusters into a single
  ``<group>_s1`` (:245,403); we preserve the subcluster membership map for
  both kept and duplicated cells — strictly more information, and our
  heatmap engine uses it for row ordering.
* The reference performs newick-string surgery on the stored hclust trees
  (:191-215,:334-369).  Our heatmap engine derives row trees lazily from
  the expression matrix at plot time, so resampled groups simply drop
  their cached ``hc`` entry instead of rewriting it.

Copied from infercnv_tpu/viz/per_group.py (all of it: ``sample_object``
:51 with the same numpy ``Generator`` draws, so it picks the same cells,
``plot_per_group`` :220) onto the port's object, checkpoints and plot_cnv;
``plot_per_group`` takes ``device``, where the shared color scale (the
centre and get_x_range_auto) and each heatmap's data side run.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from infercnv_tpu_torch.core.object import InferCNV
from infercnv_tpu_torch.device import DeviceLike, resolve_device
from infercnv_tpu_torch.utils.logging import log_info
from infercnv_tpu_torch.viz.heatmap import expr_mean, get_x_range_auto, plot_cnv


def _validate_sampling_args(n_cells, every_n, above_m) -> bool:
    """Reference argument validation (:59-85).  Returns do_every_n."""
    if every_n is not None and above_m is not None:
        if every_n < 2:
            raise ValueError("every_n needs to be at least 2, otherwise "
                             "nothing will be done.")
        if int(every_n) != every_n:
            raise ValueError("every_n needs to be an integer.")
        return True
    if every_n is not None or above_m is not None:
        log_info("To use object sampling with every_n and above_m options, "
                 "please set both. Checking if n_cells is set.")
    if n_cells is None or n_cells < 1:
        raise ValueError("Please provide a valid number of cells to sample to.")
    return False


def sample_object(obj: InferCNV, n_cells: Optional[int] = 100,
                  every_n: Optional[int] = None,
                  above_m: Optional[int] = None,
                  on_references: bool = True,
                  on_observations: bool = True,
                  seed: int = 1234) -> InferCNV:
    """Resample cells per group (reference sample_object :52-426).

    Two modes:

    * ``n_cells`` (default): every sampled group is resampled to EXACTLY
      n_cells — randomly downsampled when larger (at least one cell kept
      per subcluster when there are <= n_cells subclusters), or upsampled
      by duplicating cells when smaller (:170-244).  EVERY cell of an
      upsampled group is renamed ``<cell>_<k>`` (copy number), exactly as
      the reference suffixes all cells of upsampled groups (:340-371).
    * ``every_n`` + ``above_m`` (both required): groups larger than
      above_m keep 1 cell in every_n (dendrogram-leaf order when a tree is
      stored), always keeping at least one cell per subcluster
      (:152-163); smaller groups pass through untouched.
    """
    do_every_n = _validate_sampling_args(n_cells, every_n, above_m)
    rng = np.random.default_rng(seed)

    # per new cell: (source_index, display_name)
    picked: List[tuple] = []
    new_groups_ref: Dict[str, np.ndarray] = {}
    new_groups_obs: Dict[str, np.ndarray] = {}
    new_subclusters: Dict[str, Dict[str, list]] = {}
    kept_hc: Dict[str, np.ndarray] = {}

    def group_subclusters(group: str) -> Dict[str, np.ndarray]:
        if obj.tumor_subclusters and group in obj.tumor_subclusters["subclusters"]:
            return {k: np.asarray(v)
                    for k, v in obj.tumor_subclusters["subclusters"][group].items()}
        return {}

    def emit(group: str, entries: List[tuple], is_ref: bool,
             sub_of: Optional[Dict[int, str]] = None) -> None:
        """Register the new cells of one group (entries = [(src, name)])."""
        start = len(picked)
        picked.extend(entries)
        rng_idx = np.arange(start, start + len(entries), dtype=np.int64)
        (new_groups_ref if is_ref else new_groups_obs)[group] = rng_idx
        if sub_of is not None:
            gsub: Dict[str, list] = {}
            for pos, (src, _name) in enumerate(entries):
                # sentinel that cannot collide with a real subcluster name
                # (the reference's own flattening uses '<group>_s1')
                key = sub_of.get(int(src), f"{group}.unassigned")
                gsub.setdefault(key, []).append(start + pos)
            new_subclusters[group] = gsub

    def passthrough(group: str, idx: np.ndarray, is_ref: bool) -> None:
        subs = group_subclusters(group)
        sub_of = {int(i): k for k, v in subs.items() for i in v} if subs else None
        emit(group, [(int(i), obj.cell_names[i]) for i in idx], is_ref, sub_of)
        if (obj.tumor_subclusters
                and group in obj.tumor_subclusters.get("hc", {})
                and obj.tumor_subclusters["hc"][group] is not None):
            kept_hc[group] = obj.tumor_subclusters["hc"][group]

    def leaf_order(group: str, idx: np.ndarray) -> np.ndarray:
        """Dendrogram leaf order when a tree is stored (reference walks
        hc$order, :153-156); group order otherwise."""
        hc = (obj.tumor_subclusters or {}).get("hc", {}).get(group)
        if hc is not None and np.asarray(hc).ndim == 2:
            from scipy.cluster import hierarchy

            leaves = hierarchy.leaves_list(np.asarray(hc, np.float64))
            if leaves.size == idx.size:
                return idx[leaves]
        return idx

    def sample_group(group: str, idx: np.ndarray, is_ref: bool) -> None:
        idx = np.asarray(idx)
        subs = group_subclusters(group)
        sub_of = {int(i): k for k, v in subs.items() for i in v} if subs else None

        if do_every_n:
            if idx.size <= above_m:  # not above_m: keep everything (:165-167)
                passthrough(group, idx, is_ref)
                return
            log_info(f"Downsampling {group}")
            ordered = leaf_order(group, idx)
            sampled = ordered[::every_n]
            # every subcluster stays represented (:159-163)
            have = set(int(i) for i in sampled)
            for _sid, sidx in subs.items():
                if not any(int(i) in have for i in sidx):
                    sampled = np.append(sampled, sidx[0])
            emit(group, [(int(i), obj.cell_names[i]) for i in sampled],
                 is_ref, sub_of)
            return

        if idx.size >= n_cells:  # downsample (:149-151)
            log_info(f"Downsampling {group}")
            if subs and len(subs) <= n_cells:
                # EXACTLY n_cells via largest-remainder proportional
                # allocation with >= 1 per subcluster (keeps the every_n
                # mode's representation guarantee in n_cells mode too; the
                # reference random-samples blind here).  Falls through to
                # plain sampling when there are more subclusters than the
                # target (exactness and representation can't both hold).
                keys = list(subs.keys())
                caps = np.array([len(subs[k]) for k in keys])
                total = caps.sum()
                quota = n_cells * caps / total
                alloc = np.maximum(1, np.floor(quota).astype(int))
                alloc = np.minimum(alloc, caps)
                # distribute the remainder by largest fractional part,
                # then trim overshoot from the largest allocations
                while alloc.sum() < n_cells:
                    room = (alloc < caps)
                    frac = np.where(room, quota - alloc, -np.inf)
                    alloc[int(np.argmax(frac))] += 1
                while alloc.sum() > n_cells:
                    big = np.where(alloc > 1, alloc - quota, -np.inf)
                    alloc[int(np.argmax(big))] -= 1
                chosen: List[int] = []
                for k, m in zip(keys, alloc):
                    chosen.extend(sorted(rng.choice(
                        subs[k], size=int(m), replace=False).tolist()))
                sampled = np.asarray(chosen, np.int64)
            else:
                sampled = np.sort(rng.choice(idx, size=n_cells, replace=False))
            emit(group, [(int(i), obj.cell_names[i]) for i in sampled],
                 is_ref, sub_of)
            return

        # upsample by duplication (:170-244): n_copies each, the remainder
        # gets one extra copy; every cell is renamed <cell>_<k>
        log_info(f"Upsampling {group}")
        n_copies = n_cells // idx.size
        to_sample = n_cells % idx.size
        extra = set(rng.choice(idx.size, size=to_sample, replace=False).tolist())
        entries: List[tuple] = []
        for pos, src in enumerate(idx):
            reps = n_copies + (1 if pos in extra else 0)
            for k in range(1, reps + 1):
                entries.append((int(src), f"{obj.cell_names[src]}_{k}"))
        emit(group, entries, is_ref, sub_of)

    for g, idx in obj.ref_groups.items():
        (sample_group if on_references else passthrough)(g, np.asarray(idx), True)
    for g, idx in obj.obs_groups.items():
        (sample_group if on_observations else passthrough)(g, np.asarray(idx), False)

    src = np.array([s for s, _ in picked], np.int64)
    names = [n for _, n in picked]
    new_obj = InferCNV(
        expr=obj.expr[src],
        counts=obj.counts[src],  # cells always subset (gene axes may differ)
        gene_order=obj.gene_order,
        cell_names=names,
        ref_groups=new_groups_ref,
        obs_groups=new_groups_obs,
        options=dict(obj.options),
    )
    if obj.tumor_subclusters:
        new_obj.tumor_subclusters = {
            "subclusters": {g: {k: np.asarray(v, np.int64) for k, v in s.items()}
                            for g, s in new_subclusters.items() if s},
            "hc": kept_hc,
        }
    log_info(f"sample_object: {obj.num_cells} -> {new_obj.num_cells} cells")
    return new_obj


def plot_per_group(obj: InferCNV, out_dir: str,
                   on_references: bool = True,
                   on_observations: bool = True,
                   sample: bool = False,
                   n_cells: int = 1000,
                   every_n: Optional[int] = None,
                   above_m: Optional[int] = 1000,
                   k_obs_groups: int = 1,
                   base_filename: str = "infercnv_per_group",
                   output_format: str = "png",
                   write_expr_matrix: bool = False,
                   save_objects: bool = False,
                   png_res: int = 300,
                   dynamic_resize: float = 0.0,
                   useRaster: bool = True,
                   device: DeviceLike = None) -> list:
    """One heatmap per annotation group on a shared color scale
    (reference plot_per_group :505-661).  With sample=True, groups larger
    than above_m are passed through sample_object first (:557-566).  The
    scale's centre (summed in float64) and range, and each heatmap's data
    side, run on `device`."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    center = expr_mean(obj.expr, dev)
    lo, hi = get_x_range_auto(np.asarray(obj.expr), center, device=dev)
    out_paths = []

    def one(group: str, idx: np.ndarray, is_ref: bool):
        idx = np.asarray(idx)
        # each group becomes the sole observation block of its own object
        # (the reference plots references in the obs pane too, :540)
        sub = InferCNV(
            expr=obj.expr[idx],
            counts=obj.expr[idx],
            gene_order=obj.gene_order,
            cell_names=[obj.cell_names[i] for i in idx],
            ref_groups={},
            obs_groups={group: np.arange(idx.size)},
        )
        if obj.tumor_subclusters and group in obj.tumor_subclusters["subclusters"]:
            remap = {old: new for new, old in enumerate(idx)}
            subs = {}
            for k, sidx in obj.tumor_subclusters["subclusters"][group].items():
                kept = [remap[i] for i in np.asarray(sidx) if i in remap]
                if kept:
                    subs[k] = np.array(kept, np.int64)
            sub.tumor_subclusters = {"subclusters": {group: subs}, "hc": {}}
        if sample and above_m is not None and sub.num_cells > above_m:
            sub = sample_object(sub, n_cells=n_cells, every_n=every_n,
                                above_m=above_m if every_n is not None else None)
        safe = "".join(ch if ch.isalnum() else "_" for ch in group)
        tag = "REF" if is_ref else "OBS"
        if save_objects:
            from infercnv_tpu_torch.runner import checkpoint as ckpt

            ckpt.save_step(sub, os.path.join(
                out_dir, f"{base_filename}_{tag}_{safe}.infercnv_obj.npz"), {})
        path = plot_cnv(
            sub, out_dir=out_dir,
            output_filename=f"{base_filename}_{tag}_{safe}",
            title=f"inferCNV {group}",
            obs_title=group, ref_title="",
            cluster_by_groups=False,
            k_obs_groups=k_obs_groups,
            x_center=center, x_range=(lo, hi),
            output_format=output_format, png_res=png_res,
            dynamic_resize=dynamic_resize,
            write_expr=write_expr_matrix,
            max_pane_rows=2000 if useRaster else 10**9,
            device=dev,
        )
        out_paths.append(path)

    if on_references:
        for g, idx in obj.ref_groups.items():
            one(g, idx, True)
    if on_observations:
        for g, idx in obj.obs_groups.items():
            one(g, idx, False)
    return out_paths
