"""The benchmark of the PyTorch and CUDA port (``mocca_envs_tpu_torch``):
``python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
