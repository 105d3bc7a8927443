"""Seconds from the process's start to the window's: imports, the CUDA
context, the kernels' build or load, the pool, the serving decoder's
warm decodes and graph capture, and the warm captures."""


def read(ctx):
    return ctx.setup_s
