"""sortbench: the benchmark of the PyTorch/CUDA port (``repro_torch``).

``python sortbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (see README.md).
Nothing here imports ``jax`` or the JAX package ``repro``.
"""
