"""CPU tests of the benchmark; the cuda-marked ones run on the card."""
