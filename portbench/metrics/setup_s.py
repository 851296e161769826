"""Seconds from the process's start to the window's: imports, the CUDA
context, the kernel library, the weights and optimizer state, the input
pipeline's first window and the check's steps, which warm every shape."""


def read(run):
    return run.setup_s
