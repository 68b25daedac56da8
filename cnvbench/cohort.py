"""The traffic: a cohort of tumour samples, drawn on the device from a seed.

One general generator reads a traffic file's parameters (the number of
samples, cells a sample, reference cells and groups, subclusters, the
planted copy-number changes, the gene-mean distribution, the analysis mode
and chunk size). Every sample has the same sizes: the seed changes the gene
means, the planted chromosomes and the counts, never the work.

Counts are Poisson draws made on the device with a ``torch.Generator``, in
blocks of rows, stored as u16 (every value is clamped below 2^15, as the
port's smoke script draws them). A sample's rows: its reference cells
first (their groups in equal consecutive runs), then its observation cells,
assigned to subclusters round-robin; the subclusters from
``subclusters - planted_subclusters`` on carry one loss and one gain on two
chromosomes drawn for that sample.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from cnvbench.genomes import Genome

#: rows drawn at a time (the rates' temporary is rows x genes float32)
DRAW_ROWS = 8192


def seed_int(seed: int) -> int:
    """A seed as a non-negative 63-bit integer (numpy and torch take it)."""
    return int(seed) % (1 << 63)


@dataclasses.dataclass
class Cohort:
    counts: torch.Tensor          # u16 [samples, cells, genes]
    n_ref: int                    # reference cells a sample (its first rows)
    ref_labels: np.ndarray        # [n_ref] reference group of each
    n_ref_groups: int
    obs_labels: np.ndarray        # [cells - n_ref] subcluster of each
    n_sub: int
    planted: List[Tuple[int, int]]  # (loss chromosome, gain chromosome) a sample
    gene_means: np.ndarray        # [samples, genes]
    n_planted_subclusters: int    # the last subclusters, with the changes

    @property
    def samples(self) -> int:
        return int(self.counts.shape[0])

    @property
    def cells(self) -> int:
        return int(self.counts.shape[1])

    def group_labels(self) -> np.ndarray:
        """Group of every row of a sample for the subcluster sums: the
        subclusters 0..n_sub-1, then the reference groups."""
        return np.concatenate([self.ref_labels + self.n_sub, self.obs_labels])

    def planted_rows(self) -> np.ndarray:
        """Rows of a sample that carry the planted changes."""
        first = self.n_sub - self.n_planted_subclusters
        return self.n_ref + np.flatnonzero(self.obs_labels >= first)


def draw_cohort(traffic: dict, genome: Genome, seed: int, device) -> Cohort:
    """The cohort of a traffic mix, drawn on ``device`` from ``seed``."""
    device = torch.device(device)
    S = int(traffic["samples"])
    N = int(traffic["cells_per_sample"])
    R = int(traffic["ref_cells"])
    K_ref = int(traffic["ref_groups"])
    K_sub = int(traffic["subclusters"])
    n_planted = int(traffic["planted_subclusters"])
    G = genome.num_genes
    rng = np.random.default_rng(seed_int(seed))
    gen = torch.Generator(device=device).manual_seed(seed_int(seed))
    shape, scale = traffic["gene_mean_gamma"]
    gene_means = rng.gamma(float(shape), float(scale), (S, G))
    n_chr = len(genome.chr_ranges())
    planted = [tuple(int(c) for c in rng.choice(n_chr, 2, replace=False))
               for _ in range(S)]
    ref_labels = (np.arange(R) * K_ref) // R
    obs_labels = np.arange(N - R) % K_sub
    cohort = Cohort(counts=torch.empty((S, N, G), dtype=torch.uint16, device=device),
                    n_ref=R, ref_labels=ref_labels, n_ref_groups=K_ref,
                    obs_labels=obs_labels, n_sub=K_sub, planted=planted,
                    gene_means=gene_means, n_planted_subclusters=n_planted)
    planted_row = np.zeros(N, bool)
    planted_row[cohort.planted_rows()] = True
    planted_row = torch.as_tensor(planted_row, device=device)
    ranges = genome.chr_ranges()
    for s in range(S):
        means = torch.as_tensor(gene_means[s], dtype=torch.float32, device=device)
        fold = torch.ones(G, dtype=torch.float32, device=device)
        (lb, le), (gb, ge) = ranges[planted[s][0]], ranges[planted[s][1]]
        fold[lb:le] = float(traffic["loss_fold"])
        fold[gb:ge] = float(traffic["gain_fold"])
        for a in range(0, N, DRAW_ROWS):
            b = min(N, a + DRAW_ROWS)
            lam = torch.where(planted_row[a:b, None], means * fold, means)
            c = torch.poisson(lam, generator=gen).clamp_(max=32767)
            cohort.counts[s, a:b] = c.to(torch.int16).view(torch.uint16)
            del lam, c
    return cohort


def median_library_size(counts: torch.Tensor, block: int = DRAW_ROWS) -> float:
    """Median of the cells' total counts (u16 counts below 2^15): the norm
    factor handed to the program."""
    sizes = torch.cat([counts[a:a + block].view(torch.int16).sum(dim=1, dtype=torch.int64)
                       for a in range(0, counts.shape[0], block)])
    s, _ = torch.sort(sizes)
    n = s.shape[0]
    if n % 2:
        return float(s[n // 2])
    return float(s[n // 2 - 1] + s[n // 2]) / 2.0
