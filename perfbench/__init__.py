"""The benchmark of ``repro_torch`` (the PyTorch and CUDA port): a
data-driven harness over ``BENCHMARK.json``. Configurations, traffic
mixes and per-layer metric readers are files found by name."""
