"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one card.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line.  Nothing here
imports JAX or the JAX package; the port is the system under test.
"""
