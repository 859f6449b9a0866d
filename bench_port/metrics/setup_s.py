"""Seconds from the process's start to the window's: imports, the kernels'
load (their nvcc build on a checkout's first run), the weights, the warm-up."""


def read(rec):
    return rec.setup_s
