"""HMM parameters for the i6 CNV-state model (partial port).

Copied from infercnv_tpu/models/hmm.py (lines 35 and 102-138; plain
numpy): the state levels, ``HMMParams`` and ``state_emission_sds``.  The
hspike calibration, the i3 model and the per-group Viterbi drivers are not
ported yet.

reference: R/inferCNV_HMM.R — i6 states <-> CNV levels {0, 0.5, 1, 1.5, 2, 3};
Viterbi.dthmm.adj (:1101-1176) collapses the state sds to their median.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

I6_LEVELS = ("cnv:0.01", "cnv:0.5", "cnv:1", "cnv:1.5", "cnv:2", "cnv:3")


def state_emission_sds(num_cells: int, trend_fits: Dict[str, Tuple[float, float]],
                       levels: Sequence[str] = I6_LEVELS) -> np.ndarray:
    """sd per state for a group of `num_cells` cells
    (reference .get_state_emission_params :586-614: exp(lm predict))."""
    return np.array([
        np.exp(trend_fits[lvl][0] + trend_fits[lvl][1] * np.log(num_cells))
        for lvl in levels
    ])


@dataclasses.dataclass(frozen=True)
class HMMParams:
    means: np.ndarray    # [S] state emission means
    sds: np.ndarray      # [S] state emission sds (pre median-collapse)
    t: float             # off-diagonal transition probability

    @property
    def num_states(self) -> int:
        return self.means.shape[0]

    def delta(self) -> np.ndarray:
        """Start distribution: neutral-favoring (reference .get_HMM :230-265
        i6; .i3HMM_get_HMM i3HMM.R:99-156)."""
        S = self.num_states
        d = np.full(S, self.t)
        d[(S - 1) // 2] = 1.0 - (S - 1) * self.t
        return d

    def log_pi(self) -> np.ndarray:
        S = self.num_states
        P = np.full((S, S), self.t)
        np.fill_diagonal(P, 1.0 - (S - 1) * self.t)
        return np.log(P)
