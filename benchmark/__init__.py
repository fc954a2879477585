"""The benchmark of kgat_tpu_torch, the PyTorch/CUDA port of KGAT.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``run.py``).
Nothing here imports JAX or the JAX package ``kgat_tpu``.
"""
