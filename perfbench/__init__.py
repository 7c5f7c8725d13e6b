"""The benchmark of ``deepinv_tpu_torch`` on one NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once. Everything that belongs to one
configuration, traffic mix, per-layer metric or limit sits in a file of its
own that the harness finds by the name ``BENCHMARK.json`` gives it.
"""
