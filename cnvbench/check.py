"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the jobs
that the seed drew from the window (system.Keep) are worked out again by
the float64
reference (cnvbench/reference.py) from the same counts: the norm factor,
the reference statistics, the i3 model, the residuals and the best HMM
paths are its own.  Numbers compared, each against its limit
(cnvbench/limits/<workload>.json):

* ``resid_err``: the largest absolute difference of a kept row of the final
  (denoised) residual.  Where the reference's value before denoise lies
  within ``DENOISE_BAND`` of a denoise threshold, the program may fall on
  either side: the entry is compared with the nearer of the two outcomes.
* ``mean_err`` (subclusters): the largest absolute difference of a group
  mean (the program's sums over its counts); infinite if a group's count
  differs.
* ``state_gap``: the largest amount, over the compared chromosomes, by
  which the log-score of the program's states on the reference's input
  lies below the reference's best path.  A state path that is optimal on
  the program's own float32 input scores within rounding of the best; one
  wrong state costs a transition's log(t) or more (about 13.8 nats).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from cnvbench.cohort import Cohort
from cnvbench.genomes import Genome
from cnvbench.reference import Reference, chunks

#: a reference value this close to a denoise threshold may be denoised or not
DENOISE_BAND = 1e-3
#: rows the reference works on at a time
BLOCK_ROWS = 8192


def resid_error(got: torch.Tensor, pre: torch.Tensor, final: torch.Tensor,
                mean_ref: torch.Tensor, sd_ref: torch.Tensor) -> float:
    if tuple(got.shape) != tuple(final.shape):
        return math.inf
    got = got.to(final.dtype)
    near = ((pre - (mean_ref - sd_ref)).abs() <= DENOISE_BAND) | \
           ((pre - (mean_ref + sd_ref)).abs() <= DENOISE_BAND)
    either = torch.minimum((got - pre).abs(), (got - mean_ref).abs())
    err = torch.where(near, either, (got - final).abs())
    v = float(err.max()) if err.numel() else 0.0
    return v if math.isfinite(v) else math.inf


def compare(config: dict, genome: Genome, cohort: Cohort, traffic: dict,
            results: list, device) -> Dict[str, float]:
    """The numbers compared, over the jobs kept for the check."""
    ref = Reference(config, genome, device)
    mode = traffic["analysis_mode"]
    n_groups = cohort.n_sub + cohort.n_ref_groups
    ref_labels = torch.as_tensor(cohort.ref_labels, device=ref.device)
    labels = torch.as_tensor(cohort.group_labels(), device=ref.device)
    out = {"resid_err": 0.0, "state_gap": 0.0}
    if mode == "subclusters":
        out["mean_err"] = 0.0
    per_sample = {}
    for r in results:
        counts = cohort.counts[r.sample]
        if r.sample not in per_sample:
            nf = ref.norm_factor(counts)
            st = ref.ref_stats(counts[:cohort.n_ref], ref_labels,
                               cohort.n_ref_groups, nf)
            hmm = ref.hmm(ref.residual(counts[:cohort.n_ref], st)[0]
                          if config["hmm"]["type"] == "i3" else None)
            per_sample[r.sample] = (st, hmm)
        st, (means, sigma, t) = per_sample[r.sample]
        # u16 counts below 2^15, gathered through their int16 view
        rows = counts.view(torch.int16)[torch.as_tensor(r.rows, device=ref.device)]
        pre, final = ref.residual(rows, st)
        out["resid_err"] = max(out["resid_err"], resid_error(
            r.kept, pre, final, st.mean_ref, st.sd_ref))
        if mode == "subclusters":
            sums = cnt = 0
            for a, b in chunks(cohort.cells, BLOCK_ROWS):
                ds, dn = ref.group_sums(ref.residual(counts[a:b], st)[0],
                                        labels[a:b], n_groups)
                sums, cnt = sums + ds, cnt + dn
            want = sums / cnt[:, None]
            x = want                  # the Viterbi's input: the group means
            if (r.sums is None or tuple(r.sums.shape) != tuple(want.shape)
                    or not torch.equal(r.counts.to(cnt.device, cnt.dtype), cnt)):
                out["mean_err"] = math.inf
            else:
                got = r.sums.to(want.device, want.dtype) / cnt[:, None]
                out["mean_err"] = max(out["mean_err"], float((got - want).abs().max()))
        else:
            x = pre                   # the Viterbi's input: each cell's residual
        if tuple(r.states.shape) != tuple(x.shape):
            out["state_gap"] = math.inf
            continue
        best, _ = ref.viterbi(x, means, sigma, t, states=False)
        score = ref.path_score(x, r.states, means, sigma, t)
        gap = float((best - score).max())
        out["state_gap"] = max(out["state_gap"], gap if math.isfinite(gap) else math.inf)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a number without a limit fails)."""
    return all(k in limits and math.isfinite(v) and v <= limits[k]
               for k, v in numbers.items())
