"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Nothing here
imports JAX or the JAX package; ``inputs``, ``reference`` and the
yardstick's arithmetic import nothing of the port either.
"""
