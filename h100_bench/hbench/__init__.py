"""The H100 benchmark of ``clip_embedder_tpu_torch``: cells, configurations,
traffic mixes and per-layer metrics found by name from ``BENCHMARK.json``
and the data files beside this package (``h100_bench/run.py`` runs one)."""
