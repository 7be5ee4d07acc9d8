"""Detection ops: the plain PyTorch detector, its CUDA kernel wrapper, and keypoint compaction."""
