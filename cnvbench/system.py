"""The system under test behind one interface, and the reference in its place.

``PortSystem`` drives infercnv_tpu_torch's streaming engine
(``parallel/engine.py`` ``CnvEngine``) exactly as a job of the cohort needs
it: ``ref_stats`` on the sample's reference cells; then in subclusters mode
``subcluster_chunk`` over the sample's chunks and ``viterbi_group_means`` on
the group means, in cells mode ``full_chunk`` over the chunks; the states
(and the group sums) copied to the host.  The denoised residual of each
chunk is made on the device and freed; the jobs that the check samples
(``Keep``) first copy a few of its rows into buffers of their own.

``ReferenceSystem`` does the same job with cnvbench/reference.py: in TF32
it is the control that the comparison must refuse.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cnvbench.cohort import Cohort, median_library_size, seed_int
from cnvbench.genomes import Genome
from cnvbench.reference import Reference, chunks
from cnvbench.trace import Spans


class Keep:
    """Which of the window's jobs keep what the check compares, and where.

    The jobs are drawn from the seed by reservoir sampling: job j takes slot
    j while fewer than ``slots`` have come, else a slot with probability
    slots / (j + 1), so that the slots end up holding a uniform sample of
    all the window's jobs.  A job that takes a slot copies the final
    residual of a few rows of each chunk (a table drawn from the seed, job
    by job) into that slot's buffer, allocated in set-up: the window
    allocates nothing for the check."""

    #: jobs in the table of rows (job j uses entry j modulo this)
    TABLE_JOBS = 4096

    def __init__(self, spans, rows_per_chunk: int, slots: int, genes: int,
                 seed: int, device):
        rng = np.random.default_rng([seed_int(seed), 1])
        self.starts = np.array([a for a, _b in spans])
        sizes = np.array([b - a for a, b in spans])
        self.local = (rng.random((self.TABLE_JOBS, len(spans), rows_per_chunk))
                      * sizes[None, :, None]).astype(np.int64)
        self.local_dev = torch.as_tensor(self.local, device=device)
        self.r = rows_per_chunk
        self.slots = slots
        self.buf = torch.empty((slots, len(spans) * rows_per_chunk, genes),
                               dtype=torch.float32, device=device)
        self._draw = np.random.default_rng([seed_int(seed), 3])

    def offer(self, job: int):
        """The slot the window's job takes, or None."""
        if job < self.slots:
            return job
        r = int(self._draw.integers(0, job + 1))
        return r if r < self.slots else None

    def gather(self, final: torch.Tensor, job: int, chunk: int, slot: int):
        """Copy the job's rows of one chunk's final residual into its slot."""
        a = chunk * self.r
        torch.index_select(final, 0, self.local_dev[job % self.TABLE_JOBS, chunk],
                           out=self.buf[slot, a:a + self.r])

    def rows(self, job: int) -> np.ndarray:
        """Rows of the sample, in the order of the slot's buffer."""
        return (self.local[job % self.TABLE_JOBS] + self.starts[:, None]).reshape(-1)


@dataclasses.dataclass
class JobResult:
    sample: int
    rows: np.ndarray                  # sample rows of the kept residual
    kept: torch.Tensor                # final residual of those rows [R, G]
    states: torch.Tensor              # host int8: [K, G] groups, or [R, G] rows
    sums: Optional[torch.Tensor] = None    # host [K, G] group sums (subclusters)
    counts: Optional[torch.Tensor] = None  # host [K] cells a group


class _Common:
    """What both systems share: the chunks, the groups, the norm factors."""

    def __init__(self, cohort: Cohort, traffic: dict, device):
        self.cohort = cohort
        self.device = torch.device(device)
        self.mode = traffic["analysis_mode"]
        if self.mode not in ("subclusters", "cells"):
            raise ValueError(f"unknown analysis_mode {self.mode!r}")
        self.spans = chunks(cohort.cells, int(traffic["chunk_cells"]))
        self.n_groups = cohort.n_sub + cohort.n_ref_groups
        # the norm factor a caller hands over: each sample's median library size
        self.nf = [median_library_size(cohort.counts[s]) for s in range(cohort.samples)]
        self.host_states = None
        if self.mode == "cells":
            self.host_states = torch.empty(
                (cohort.cells, cohort.counts.shape[2]), dtype=torch.int8,
                pin_memory=self.device.type == "cuda")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()


class PortSystem(_Common):
    """infercnv_tpu_torch's CnvEngine, one engine a distinct HMM."""

    def __init__(self, config: dict, genome: Genome, cohort: Cohort,
                 traffic: dict, device):
        from infercnv_tpu_torch.core.genome import GeneOrder
        from infercnv_tpu_torch.models.hmm import HMMParams, i3_hmm_params
        from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig

        super().__init__(cohort, traffic, device)
        G = genome.num_genes
        go = GeneOrder(names=tuple(f"g{i}" for i in range(G)),
                       chr_names=genome.chr_names, chr_ids=genome.chr_ids,
                       start=genome.start, stop=genome.stop)
        ecfg = EngineConfig(**config["engine"])
        dev = self.device
        R = cohort.n_ref
        self.onehot_ref = torch.zeros((cohort.n_ref_groups, R), device=dev)
        self.onehot_ref[torch.as_tensor(cohort.ref_labels, device=dev),
                        torch.arange(R, device=dev)] = 1
        self.onehots = []
        if self.mode == "subclusters":
            labels = torch.as_tensor(cohort.group_labels(), device=dev)
            onehot = torch.zeros((self.n_groups, cohort.cells), device=dev)
            onehot[labels, torch.arange(cohort.cells, device=dev)] = 1
            self.onehots = [onehot[:, a:b].contiguous() for a, b in self.spans]
        h = config["hmm"]
        if h["type"] == "i6":
            engine = CnvEngine(go, HMMParams(means=np.asarray(h["means"]),
                                             sds=np.asarray(h["sds"]), t=h["t"]),
                               ecfg, device=dev)
            self.engines = [engine] * cohort.samples
        else:
            # i3: each sample's model from its reference cells' residual, as
            # run() derives it; the engine binds its HMM, so one engine each
            base = CnvEngine(go, HMMParams(means=np.array([0.5, 1.0, 1.5]),
                                           sds=np.ones(3), t=h["t"]),
                             ecfg, device=dev)
            groups = [np.flatnonzero(cohort.ref_labels == k)
                      for k in range(cohort.n_ref_groups)]
            self.engines = []
            for s in range(cohort.samples):
                ref = cohort.counts[s, :R]
                ml, mr, _ = base.ref_stats(ref, self.nf[s], self.onehot_ref)
                pre = base.transform_chunk(ref, self.nf[s], ml, mr)
                h3 = i3_hmm_params(pre, groups, [], t=h["t"], i3_p_val=h["p_val"])
                del pre
                self.engines.append(CnvEngine(go, h3, ecfg, device=dev))

    def job(self, j: int, s: int, keep: Keep, slot, spans: Spans):
        """One job; a JobResult when it takes a slot of the check, else None."""
        eng = self.engines[s]
        counts = self.cohort.counts[s]
        nf = self.nf[s]
        with spans("ref_stats"):
            ml, mr, noise = eng.ref_stats(counts[:self.cohort.n_ref], nf,
                                          self.onehot_ref)
        if self.mode == "subclusters":
            acc = None
            for c, (a, b) in enumerate(self.spans):
                with spans("chunk"):
                    final, *acc = eng.subcluster_chunk(counts[a:b], nf, ml, mr,
                                                       noise, self.onehots[c],
                                                       acc=acc)
                if slot is not None:
                    keep.gather(final, j, c, slot)
                del final
            with spans("viterbi"):
                states = eng.viterbi_group_means(acc[0] / acc[1][:, None])
            out = (states.cpu(), acc[0].cpu(), acc[1].cpu())
            return (None if slot is None else
                    JobResult(s, keep.rows(j), keep.buf[slot], *out))
        for c, (a, b) in enumerate(self.spans):
            with spans("chunk"):
                final, states = eng.full_chunk(counts[a:b], nf, ml, mr, noise)
            if slot is not None:
                keep.gather(final, j, c, slot)
            self.host_states[a:b].copy_(states, non_blocking=True)
            del final, states
        self._sync()
        if slot is None:
            return None
        rows = keep.rows(j)
        return JobResult(s, rows, keep.buf[slot],
                         self.host_states[torch.as_tensor(rows)].clone())


class ReferenceSystem(_Common):
    """The control: the reference in TF32 put in the program's place."""

    def __init__(self, config: dict, genome: Genome, cohort: Cohort,
                 traffic: dict, device):
        super().__init__(cohort, traffic, device)
        self.ref = Reference(config, genome, self.device, torch.float32, tf32=True)
        self.ref_labels = torch.as_tensor(cohort.ref_labels, device=self.device)
        self.labels = torch.as_tensor(cohort.group_labels(), device=self.device)
        self.hmms = [self.ref.hmm(self._ref_pre(s)) if config["hmm"]["type"] == "i3"
                     else self.ref.hmm() for s in range(cohort.samples)]

    def _stats(self, s):
        c = self.cohort
        return self.ref.ref_stats(c.counts[s, :c.n_ref], self.ref_labels,
                                  c.n_ref_groups, self.nf[s])

    def _ref_pre(self, s):
        return self.ref.residual(self.cohort.counts[s, :self.cohort.n_ref],
                                 self._stats(s))[0]

    def job(self, j: int, s: int, keep: Keep, slot, spans: Spans):
        counts = self.cohort.counts[s]
        st = self._stats(s)
        means, sigma, t = self.hmms[s]
        if self.mode == "subclusters":
            sums = cnt = 0
            for c, (a, b) in enumerate(self.spans):
                pre, final = self.ref.residual(counts[a:b], st)
                if slot is not None:
                    keep.gather(final.float(), j, c, slot)
                ds, dn = self.ref.group_sums(pre, self.labels[a:b], self.n_groups)
                sums, cnt = sums + ds, cnt + dn
            _, states = self.ref.viterbi(sums / cnt[:, None], means, sigma, t)
            return (None if slot is None else
                    JobResult(s, keep.rows(j), keep.buf[slot], states.cpu(),
                              sums.float().cpu(), cnt.float().cpu()))
        for c, (a, b) in enumerate(self.spans):
            pre, final = self.ref.residual(counts[a:b], st)
            if slot is not None:
                keep.gather(final.float(), j, c, slot)
            self.host_states[a:b].copy_(self.ref.viterbi(pre, means, sigma, t)[1])
        self._sync()
        if slot is None:
            return None
        rows = keep.rows(j)
        return JobResult(s, rows, keep.buf[slot],
                         self.host_states[torch.as_tensor(rows)].clone())
