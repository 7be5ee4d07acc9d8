"""Host utilities: image I/O, golden hashing, and the CUDA kernel build."""
