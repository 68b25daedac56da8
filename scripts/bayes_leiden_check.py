#!/usr/bin/env python3
"""Does the Bayesian filter lower the planted gain share of Leiden
subclusters that mix both sides, in the JAX package as in the port?

    JAX_PLATFORMS=cpu python3 scripts/bayes_leiden_check.py

Builds chip_smoke.py's run object (make_run_object: obs4-obs7 with chr2 at
0.5x and chr5 at 2x) at 8 x 60 + 2 x 40 cells and runs run() with one
Leiden group (cluster_by_groups=False) at BayesMaxPNormal 0 and 0.5, in the
JAX package and in the port on the CPU, printing chip_smoke.leiden_calls
and the regions modelled, removed and reassigned.  Outputs go to
build/bayes_leiden_check/.  The two packages' Leiden partitions differ
(their PCA draws differ); each is compared with itself, filter off and on.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import infercnv_tpu.runner.pipeline as jp  # noqa: E402
import infercnv_tpu_torch.runner.pipeline as tp  # noqa: E402
from infercnv_tpu.core.genome import GeneOrder as JaxGeneOrder  # noqa: E402
from infercnv_tpu.core.object import InferCNV as JaxInferCNV  # noqa: E402


def main() -> None:
    obj, _ = cs.make_run_object(cs.bench_genome(), 60, 40)
    go = obj.gene_order
    jo = JaxInferCNV(
        expr=obj.expr.copy(), counts=obj.counts.copy(),
        gene_order=JaxGeneOrder(names=go.names, chr_names=go.chr_names,
                                chr_ids=go.chr_ids, start=go.start, stop=go.stop),
        cell_names=list(obj.cell_names), ref_groups=dict(obj.ref_groups),
        obs_groups=dict(obj.obs_groups), options=dict(obj.options))
    kw = dict(HMM=True, HMM_type="i6", analysis_mode="subclusters",
              cluster_by_groups=False, save_rds=False, no_plot=True, denoise=True)
    out = ROOT / "build" / "bayes_leiden_check"
    for name, run, o, extra in (("jax", jp.run, jo, {}),
                                ("port", tp.run, obj, {"device": "cpu"})):
        for p in (0, 0.5):
            r = run(o, str(out / f"{name}_{p}"), BayesMaxPNormal=p, **kw, **extra)
            c = cs.leiden_calls(r)
            b = r.bayes_result
            print(name, p, {k: c[k] for k in ("del_chr2", "amp_chr5", "neutral_obs0_3_refs",
                                              "subclusters", "min_one_side_share")},
                  None if b is None else {"modelled": len(b.cnv_region_names),
                                          "removed": len(b.removed_regions),
                                          "reassigned": len(b.reassigned)}, flush=True)


if __name__ == "__main__":
    main()
