"""The benchmark of the PyTorch / CUDA port (``blurred_gan_tpu_torch``).

``python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Everything
that belongs to one configuration, traffic kind, cell or per-layer metric is
a file of its own, found by its name (``spec.py``).
"""
