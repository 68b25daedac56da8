"""The benchmark of infercnv_tpu_torch on one NVIDIA GPU: each cell runs
jobs of one kind (cnvbench/jobs/), back to back; the engine kind calls a
cohort of tumour samples through the port's streaming engine.

``python cnvbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; see run.py.
"""
