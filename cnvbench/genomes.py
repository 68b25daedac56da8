"""Gene orders of the configurations, as plain numpy arrays.

Frozen copies of the generators the port's smoke script uses
(``bench_genome``: bench.py's genome of 22 chromosomes; ``human_like_genome``:
GRCh38 chromosome lengths with genes in proportion to protein-coding counts).
They import nothing of the port: the reference reads the arrays directly and
the port's adapter (system.py) wraps them in its own GeneOrder.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: GRCh38 chromosome lengths, chr1..chr22, in Mbp
GRCH38_MBP = (248.96, 242.19, 198.30, 190.21, 181.54, 170.81, 159.35, 145.14,
              138.39, 133.80, 135.09, 133.28, 114.36, 107.04, 101.99, 90.34,
              83.26, 80.37, 58.62, 64.44, 46.71, 50.82)
#: approximate protein-coding gene counts per chromosome (relative weights)
PROTEIN_CODING = (2050, 1300, 1080, 750, 880, 1040, 920, 690, 780, 730, 1310,
                  1030, 320, 610, 600, 850, 1180, 270, 1470, 540, 230, 440)


@dataclasses.dataclass(frozen=True)
class Genome:
    """Genes in genomic order: chromosome index, start and stop of each."""

    chr_ids: np.ndarray      # int32 [G], contiguous runs 0..n_chr-1
    start: np.ndarray        # int64 [G]
    stop: np.ndarray         # int64 [G]

    @property
    def num_genes(self) -> int:
        return int(self.chr_ids.shape[0])

    @property
    def chr_names(self) -> tuple:
        return tuple(f"chr{i + 1}" for i in range(int(self.chr_ids.max()) + 1))

    def chr_ranges(self) -> list:
        """[begin, end) of each chromosome."""
        edges = np.flatnonzero(np.diff(self.chr_ids)) + 1
        bounds = np.concatenate([[0], edges, [self.num_genes]])
        return [(int(b), int(e)) for b, e in zip(bounds[:-1], bounds[1:])]


def bench_genome(G: int = 8448, n_chr: int = 22) -> Genome:
    """bench.py's genome: G genes on n_chr chromosomes of linearly falling
    size, start = stop = gene index."""
    sizes = np.linspace(800, 120, n_chr).astype(int)
    sizes = (sizes / sizes.sum() * G).astype(int)
    sizes[0] += G - sizes.sum()
    G = int(sizes.sum())
    return Genome(chr_ids=np.repeat(np.arange(n_chr), sizes).astype(np.int32),
                  start=np.arange(G, dtype=np.int64),
                  stop=np.arange(G, dtype=np.int64))


def human_like_genome(G: int, seed: int = 0) -> Genome:
    """G genes on the 22 autosomes of GRCh38: chromosome lengths as there,
    genes per chromosome in proportion to their protein-coding genes (the
    remainder to chr1), starts uniform along each chromosome and sorted,
    lengths 5-60 kbp."""
    rng = np.random.default_rng(seed)
    w = np.asarray(PROTEIN_CODING, np.float64)
    n = (w / w.sum() * G).astype(int)
    n[0] += G - n.sum()
    starts, stops = [], []
    for mbp, k in zip(GRCH38_MBP, n):
        s = np.sort(rng.integers(0, int(mbp * 1e6) - 60_000, k))
        starts.append(s)
        stops.append(s + rng.integers(5_000, 60_001, k))
    return Genome(chr_ids=np.repeat(np.arange(22), n).astype(np.int32),
                  start=np.concatenate(starts).astype(np.int64),
                  stop=np.concatenate(stops).astype(np.int64))


def make_genome(spec: dict) -> Genome:
    """The genome a configuration file's ``genome`` entry describes."""
    kind = spec["kind"]
    if kind == "bench":
        return bench_genome(int(spec["genes"]), int(spec.get("chromosomes", 22)))
    if kind == "human_like":
        return human_like_genome(int(spec["genes"]), int(spec.get("seed", 0)))
    raise ValueError(f"unknown genome kind {kind!r}")
