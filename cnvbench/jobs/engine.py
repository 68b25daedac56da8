"""engine: a cohort of tumour samples called back to back through the
port's streaming engine, a job a sample (cnvbench/system.py PortSystem).

The data is the configuration's genome and the traffic's cohort, drawn on
the device from the seed (cnvbench/cohort.py); the control is the
reference in TF32 (ReferenceSystem); the check keeps a few rows of each
chunk of the jobs that system.Keep draws, and check.compare works them out
again with the float64 reference.
"""

from __future__ import annotations

import dataclasses

from cnvbench import check, reference
from cnvbench.cohort import Cohort, draw_cohort
from cnvbench.genomes import Genome, make_genome
from cnvbench.system import Keep, PortSystem, ReferenceSystem

SETUP_PARTS = ("cohort_draws", "samples_and_engines")


@dataclasses.dataclass
class Data:
    genome: Genome
    cohort: Cohort


def draw(config: dict, traffic: dict, seed: int, device) -> Data:
    genome = make_genome(config["genome"])
    return Data(genome, draw_cohort(traffic, genome, seed, device))


def port(config: dict, traffic: dict, data: Data, device) -> PortSystem:
    return PortSystem(config, data.genome, data.cohort, traffic, device)


def control(config: dict, traffic: dict, data: Data, device) -> ReferenceSystem:
    return ReferenceSystem(config, data.genome, data.cohort, traffic, device)


def keep(config: dict, traffic: dict, data: Data, system, seed: int, device) -> Keep:
    return Keep(system.spans, int(traffic["check"]["rows_per_chunk"]),
                int(traffic["check"]["jobs"]), data.genome.num_genes, seed, device)


def facts(config: dict, traffic: dict, data: Data, system, traced: bool) -> dict:
    """The sizes the readers count work from; the smoothing operator's
    non-zeros (the rooflines') only in a traced run."""
    genome, cohort = data.genome, data.cohort
    out = {"samples": cohort.samples, "cells_per_job": cohort.cells,
           "ref_cells": cohort.n_ref, "genes": genome.num_genes,
           "chunks_per_job": len(system.spans),
           "hmm_states": 6 if config["hmm"]["type"] == "i6" else 3,
           "band_nonzeros": 0}
    if traced:
        out["band_nonzeros"] = reference.band_nonzeros(
            genome, config["engine"]["smooth_method"],
            int(config["engine"]["window_length"]))
    return out


def compare(config: dict, traffic: dict, data: Data, results: list, device) -> dict:
    return check.compare(config, data.genome, data.cohort, traffic, results, device)
