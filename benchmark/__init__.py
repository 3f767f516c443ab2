"""The benchmark of geeco_tpu_torch, the PyTorch and CUDA port of GEECO.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card; see
``README.md``.  Nothing here imports JAX or the JAX package.
"""
