"""Seconds from the process's start to the first timed request: imports,
CUDA initialisation, the kernels' build (first run of a checkout only),
the inputs and the warm-up."""


def read(run):
    return run.setup_s
