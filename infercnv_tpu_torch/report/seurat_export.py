"""Downstream metadata export — the add_to_seurat analogue.

reference: R/seurat_interaction.R add_to_seurat (:23-214) + .get_features
(:244-616): from the final object and the HMM region/gene reports, build
per-chromosome per-cell features (has_cnv / has_loss / has_dupli booleans,
gene-count proportions, i6 |state - center|-scaled proportions) and top-N
largest loss/dupli CNVs matched across cell groups by bp tolerance; write
``map_metadata_from_infercnv.txt`` (plus top_losses.txt / top_dupli.txt).

Python-side interop targets: a pandas-style TSV always, and an AnnData
``.obs`` update when anndata/scanpy objects are passed (the Python
ecosystem's Seurat counterpart).

Copied from infercnv_tpu/report/seurat_export.py (all of it:
``compute_cnv_features`` :50, ``load_group_regions_from_out_dir`` :149,
``add_to_seurat`` :240, ``add_to_metadata`` :260), host code on the port's
object, region reports, checkpoints and RDS reader.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from infercnv_tpu_torch.core.object import InferCNV
from infercnv_tpu_torch.report.regions import GroupRegions
from infercnv_tpu_torch.utils.logging import log_info, log_warn


def _top_n_regions(region_rows: List[dict], top_n: int, bp_tolerance: float):
    """Group same-CNV regions across cell groups by (chr, ~start, ~end)
    within bp_tolerance; return top_n by total gene count
    (reference .get_top_n_regions seurat_interaction.R:618+)."""
    clusters: List[dict] = []
    rows = sorted(region_rows, key=lambda r: -r["n_genes"])
    for r in rows:
        placed = False
        for cl in clusters:
            if (cl["chr"] == r["chr"]
                    and abs(cl["start"] - r["start"]) <= bp_tolerance
                    and abs(cl["end"] - r["end"]) <= bp_tolerance):
                cl["groups"].append(r["group"])
                cl["n_genes"] += r["n_genes"]
                placed = True
                break
        if not placed:
            clusters.append({"chr": r["chr"], "start": r["start"], "end": r["end"],
                             "groups": [r["group"]], "n_genes": r["n_genes"]})
    clusters.sort(key=lambda c: -c["n_genes"])
    return clusters[:top_n]


def compute_cnv_features(
    obj: InferCNV,
    group_regions: List[GroupRegions],
    hmm_type: str = "i6",
    top_n: int = 10,
    bp_tolerance: float = 2_000_000,
) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Returns ({feature_name: [C] vector}, feature order)."""
    center = 3 if hmm_type == "i6" else 2
    scaling = 2.0
    C = obj.num_cells
    go = obj.gene_order
    chr_gene_count = {go.chr_names[ci]: max(e - b, 1)
                      for ci, (b, e) in enumerate(go.chr_ranges())}
    name_to_cell = {n: i for i, n in enumerate(obj.cell_names)}

    feats: Dict[str, np.ndarray] = {}
    order: List[str] = []
    kinds = ["has_cnv", "has_loss", "has_dupli",
             "proportion_cnv", "proportion_loss", "proportion_dupli"]
    if hmm_type == "i6":
        kinds += ["proportion_scaled_cnv", "proportion_scaled_loss",
                  "proportion_scaled_dupli"]
    for lv in go.chr_names:
        for k in kinds:
            name = f"{k}_{lv}"
            feats[name] = np.zeros(C, bool) if k.startswith("has") else np.zeros(C)
            order.append(name)

    loss_rows, dupli_rows = [], []
    for gr in group_regions:
        cells = np.array([name_to_cell[c] for c in gr.cells], np.int64)
        if cells.size == 0:
            continue
        # pool per-gene states per chromosome for this group
        per_chr: Dict[str, List[Tuple[int, str]]] = {}
        for r in gr.regions:
            if r.state == center:
                continue
            per_chr.setdefault(r.chrom, []).extend(
                (s, g) for s, g in zip(r.gene_states, r.genes))
            row = {"group": gr.group_name, "chr": r.chrom, "start": r.start,
                   "end": r.end, "n_genes": len(r.genes)}
            (loss_rows if r.state < center else dupli_rows).append(row)
        for c, entries in per_chr.items():
            states = np.array([s for s, _ in entries])
            denom = chr_gene_count[c]
            feats[f"has_cnv_{c}"][cells] = True
            feats[f"proportion_cnv_{c}"][cells] = states.size / denom
            if hmm_type == "i6":
                feats[f"proportion_scaled_cnv_{c}"][cells] = (
                    np.abs(states - center).sum() / (denom * scaling))
            loss = states[states < center]
            if loss.size:
                feats[f"has_loss_{c}"][cells] = True
                feats[f"proportion_loss_{c}"][cells] = loss.size / denom
                if hmm_type == "i6":
                    feats[f"proportion_scaled_loss_{c}"][cells] = (
                        abs((loss - center).sum()) / (denom * scaling))
            dupli = states[states > center]
            if dupli.size:
                feats[f"has_dupli_{c}"][cells] = True
                feats[f"proportion_dupli_{c}"][cells] = dupli.size / denom
                if hmm_type == "i6":
                    feats[f"proportion_scaled_dupli_{c}"][cells] = (
                        (dupli - center).sum() / (denom * scaling))

    group_cells = {gr.group_name: np.array([name_to_cell[c] for c in gr.cells],
                                           np.int64)
                   for gr in group_regions}
    for label, rows in (("top_loss", loss_rows), ("top_dupli", dupli_rows)):
        tops = _top_n_regions(rows, top_n, bp_tolerance)
        for i, cl in enumerate(tops, start=1):
            name = f"{label}_{i}"
            v = np.zeros(C, bool)
            for g in cl["groups"]:
                v[group_cells[g]] = True
            feats[name] = v
            order.append(name)
    return feats, order


def _read_tsv_rows(path: str) -> List[Dict[str, str]]:
    def unq(s: str) -> str:
        return s[1:-1] if len(s) >= 2 and s[0] == s[-1] and s[0] == '"' else s

    with open(path) as f:
        header = [unq(h) for h in f.readline().rstrip("\n").split("\t")]
        rows = []
        for line in f:
            parts = [unq(p) for p in line.rstrip("\n").split("\t")]
            if len(parts) == len(header) + 1:
                # R write.table default row.names=TRUE: data rows carry a
                # leading row-name field the header doesn't have
                parts = parts[1:]
            rows.append(dict(zip(header, parts)))
    return rows


def load_group_regions_from_out_dir(infercnv_output_path: str):
    """Reconstruct (final InferCNV object, GroupRegions, hmm_type) from a
    finished out_dir's files — the reference's file-based ``add_to_seurat``
    mode (R/seurat_interaction.R:23-100): prefers the post-Bayes-filter
    ``HMM_CNV_predictions…Pnorm_*`` reports, falls back to the raw step-17
    ``17_HMM_pred…`` reports, and detects i6/i3 from the file names."""
    import glob
    import re

    from infercnv_tpu_torch.report.regions import CnvRegion, GroupRegions
    from infercnv_tpu_torch.runner.checkpoint import load_step

    final_path = os.path.join(infercnv_output_path, "run.final.infercnv_obj.npz")
    rds_path = os.path.join(infercnv_output_path, "run.final.infercnv_obj")
    if os.path.exists(final_path):
        obj, _args, _states = load_step(final_path)
    elif os.path.exists(rds_path):
        # a reference-R run directory (or our RDS interop output)
        from infercnv_tpu_torch.io.rds import read_rds_infercnv

        obj = read_rds_infercnv(rds_path)
    else:
        raise FileNotFoundError(
            f'Could not find "run.final.infercnv_obj[.npz]" at: {infercnv_output_path}')

    cand = sorted(glob.glob(os.path.join(
        infercnv_output_path, "HMM_CNV_predictions.*Pnorm_*.pred_cnv_regions.dat")))
    if not cand:
        cand = sorted(glob.glob(os.path.join(
            infercnv_output_path, "17_HMM_pred*.pred_cnv_regions.dat")))
    if not cand:
        raise FileNotFoundError(
            f"no HMM region reports (*.pred_cnv_regions.dat) in {infercnv_output_path}")
    regions_path = cand[0]
    base = regions_path[: -len(".pred_cnv_regions.dat")]
    genes_path = base + ".pred_cnv_genes.dat"
    m = re.search(r"HMMi(\d)", os.path.basename(regions_path))
    hmm_type = f"i{m.group(1)}" if m else "i6"

    groupings = sorted(glob.glob(os.path.join(
        infercnv_output_path, "17_HMM_pred*.cell_groupings")))
    cells_by_group: Dict[str, List[str]] = {}
    if groupings:
        for row in _read_tsv_rows(groupings[0]):
            cells_by_group.setdefault(row["cell_group_name"], []).append(row["cell"])

    by_group: Dict[str, Dict[str, CnvRegion]] = {}
    for row in _read_tsv_rows(regions_path):
        g = row["cell_group_name"]
        by_group.setdefault(g, {})[row["cnv_name"]] = CnvRegion(
            name=row["cnv_name"], state=int(row["state"]), chrom=row["chr"],
            start=int(row["start"]), end=int(row["end"]),
            genes=[], gene_states=[], gene_starts=[], gene_stops=[])
    if not os.path.exists(genes_path):
        log_warn(f"{genes_path} missing: per-gene counts unavailable, so "
                 "proportion_* features will be 0 and top-N CNV ranking "
                 "is by region count only")
    else:
        for row in _read_tsv_rows(genes_path):
            reg = by_group.get(row["cell_group_name"], {}).get(row["gene_region_name"])
            if reg is None:
                continue
            reg.genes.append(row["gene"])
            reg.gene_states.append(int(row["state"]))
            reg.gene_starts.append(int(row["start"]))
            reg.gene_stops.append(int(row["end"]))

    group_regions: List[GroupRegions] = []
    for g, regs in by_group.items():
        cells = cells_by_group.get(g)
        if cells is None:
            # fall back to the object's group/subcluster structure
            sub = None
            if obj.tumor_subclusters:
                for _gg, subs in obj.tumor_subclusters["subclusters"].items():
                    if g in subs:
                        sub = subs[g]
                        break
            if sub is None:
                sub = dict(obj.obs_groups, **obj.ref_groups).get(g, np.zeros(0, np.int64))
            cells = [obj.cell_names[i] for i in np.asarray(sub)]
        group_regions.append(GroupRegions(group_name=g, cells=cells,
                                          regions=list(regs.values())))
    # groups present in .cell_groupings but without any CNV region still
    # contribute their cells (all-neutral groups)
    for g, cells in cells_by_group.items():
        if g not in by_group:
            group_regions.append(GroupRegions(group_name=g, cells=cells, regions=[]))
    return obj, group_regions, hmm_type


def add_to_seurat(
    infercnv_output_path: str,
    top_n: int = 10,
    bp_tolerance: float = 2_000_000,
    adata=None,
    column_prefix: str = "",
):
    """File-based metadata export from a FINISHED run directory (the
    reference's exported ``add_to_seurat`` R/seurat_interaction.R:23-214):
    works across processes, no in-memory objects required.  Attaches to an
    AnnData ``.obs`` when given (Python's Seurat counterpart) and always
    writes ``map_metadata_from_infercnv.txt``."""
    obj, group_regions, hmm_type = load_group_regions_from_out_dir(
        infercnv_output_path)
    return add_to_metadata(obj, group_regions, infercnv_output_path,
                           hmm_type=hmm_type, top_n=top_n,
                           bp_tolerance=bp_tolerance, adata=adata,
                           column_prefix=column_prefix)


def add_to_metadata(
    obj: InferCNV,
    group_regions: List[GroupRegions],
    out_dir: str,
    hmm_type: str = "i6",
    top_n: int = 10,
    bp_tolerance: float = 2_000_000,
    adata=None,
    column_prefix: str = "",
):
    """Write map_metadata_from_infercnv.txt; optionally attach features as
    columns of an AnnData .obs (anndata being Python's Seurat metadata
    analogue).  Returns the feature dict."""
    feats, order = compute_cnv_features(obj, group_regions, hmm_type, top_n,
                                        bp_tolerance)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "map_metadata_from_infercnv.txt")
    with open(path, "w") as f:
        f.write("\t" + "\t".join(column_prefix + n for n in order) + "\n")
        for i, cell in enumerate(obj.cell_names):
            vals = []
            for n in order:
                v = feats[n][i]
                vals.append(str(bool(v)) if feats[n].dtype == bool else f"{v:g}")
            f.write(cell + "\t" + "\t".join(vals) + "\n")
    log_info(f"-wrote {path}")

    # top losses / duplications membership files (reference :400-470)
    for label in ("top_loss", "top_dupli"):
        fname = "top_losses.txt" if label == "top_loss" else "top_dupli.txt"
        with open(os.path.join(out_dir, fname), "w") as f:
            for n in order:
                if n.startswith(label):
                    members = [obj.cell_names[i] for i in np.nonzero(feats[n])[0]]
                    f.write(";".join([n] + members) + "\n")

    if adata is not None:
        # align by CELL NAME, not position — the AnnData may be ordered or
        # filtered independently of the infercnv input (the reference's
        # add_to_seurat does the same via match(), seurat_interaction.R:55)
        take = None
        obs_names = getattr(adata, "obs_names", None)
        if obs_names is not None:
            lut = {c: i for i, c in enumerate(obj.cell_names)}
            hits = [lut.get(str(c), -1) for c in obs_names]
            n_miss = sum(1 for h in hits if h < 0)
            if n_miss == 0:
                take = np.asarray(hits)
            elif n_miss < len(hits):
                raise ValueError(
                    f"{n_miss}/{len(hits)} AnnData obs_names not found in "
                    "the infercnv object's cells; cannot align metadata")
            else:
                log_warn("AnnData obs_names share no cells with the "
                         "infercnv object; assigning features positionally")
        for n in order:
            vals = np.asarray(feats[n])
            adata.obs[column_prefix + n] = vals[take] if take is not None else vals
    return feats
