"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell
at a time, found by name (``BENCHMARK.json``). ``run.py`` is the entry."""
