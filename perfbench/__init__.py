"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything one configuration, traffic mix or metric
needs sits in a file of its own under ``configs/``, ``traffic/`` and
``metrics/``, found by the name ``BENCHMARK.json`` gives it.
"""
