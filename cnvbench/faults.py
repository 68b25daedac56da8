"""Faults planted under the timed path, for the check that the comparison
refuses them (cnvbench/tests and cnvbench/readings.py; never in a
benchmark run).

``planted(name)`` patches infercnv_tpu_torch's CnvEngine for the duration of
a ``with`` block:

* ``unchanged_state``: a step returns its state unchanged: a chunk after the
  first leaves the group sums as they came, and the reference statistics
  stay those of their first call (every later sample reuses them);
* ``half_batch``: half of the batch left out, the mean taken over the rest:
  each chunk's group sums and counts over its first half, and the
  reference statistics over every other reference cell;
* ``altered_answer``: an answer altered where it is produced: the states of
  the first gene moved to the next state, and the first gene of every final
  residual row raised by 0.25.

The cohort runs on one chip, so there is no exchange between chips to leave
out.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged_state", "half_batch", "altered_answer")


def _next_state(states: torch.Tensor, n_states: int) -> torch.Tensor:
    out = states.clone()
    out[:, 0] = out[:, 0] % n_states + 1
    return out


@contextlib.contextmanager
def planted(name: str):
    from infercnv_tpu_torch.parallel.engine import CnvEngine

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")
    orig = {k: getattr(CnvEngine, k) for k in
            ("subcluster_chunk", "full_chunk", "ref_stats", "viterbi_group_means")}
    first = {}

    def subcluster_chunk(self, counts, nf, ml, mr, noise, onehot, acc=None):
        if name == "half_batch":
            onehot = torch.as_tensor(onehot).clone()
            onehot[:, onehot.shape[1] // 2:] = 0
        final, sums, cnt = orig["subcluster_chunk"](self, counts, nf, ml, mr, noise,
                                                    onehot, acc=acc)
        if name == "unchanged_state" and acc is not None:
            sums, cnt = acc
        if name == "altered_answer":
            final = final.clone()
            final[:, 0] += 0.25
        return final, sums, cnt

    def full_chunk(self, counts, nf, ml, mr, noise=None):
        final, states = orig["full_chunk"](self, counts, nf, ml, mr, noise)
        if name == "altered_answer":
            final = final.clone()
            final[:, 0] += 0.25
            states = _next_state(states, self.hmm.num_states)
        return final, states

    def ref_stats(self, ref_counts, nf, group_onehot=None):
        if name == "half_batch" and group_onehot is not None:
            ref_counts = ref_counts[::2]
            group_onehot = torch.as_tensor(group_onehot)[:, ::2]
        stats = orig["ref_stats"](self, ref_counts, nf, group_onehot)
        if name == "unchanged_state":
            stats = first.setdefault("stats", stats)
        return stats

    def viterbi_group_means(self, group_means, *args, **kw):
        states = orig["viterbi_group_means"](self, group_means, *args, **kw)
        if name == "altered_answer":
            states = _next_state(states, self.hmm.num_states)
        return states

    patches = {"subcluster_chunk": subcluster_chunk, "full_chunk": full_chunk,
               "viterbi_group_means": viterbi_group_means, "ref_stats": ref_stats}
    try:
        for k, fn in patches.items():
            setattr(CnvEngine, k, fn)
        yield
    finally:
        for k, fn in orig.items():
            setattr(CnvEngine, k, fn)
