"""Benchmark of the PyTorch port (``repro_torch``) of the TASQ allocation
system on one NVIDIA card. ``python3 tasq_bench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` runs one cell once; see
``harness.py``."""
