"""Part of the benchmark of the PyTorch/CUDA port (see BENCHMARK.json)."""
