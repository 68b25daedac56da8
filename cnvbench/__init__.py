"""The benchmark of infercnv_tpu_torch: a cohort of tumour samples called
back to back through the port's streaming engine on one NVIDIA GPU.

``python cnvbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; see run.py.
"""
