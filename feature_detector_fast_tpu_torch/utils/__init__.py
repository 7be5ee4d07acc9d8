"""Host utilities: image I/O, golden hashing, the CUDA kernel build,
trajectory metrics (``metrics``) and the TF32-off guard of the geometry
(``precision``)."""
