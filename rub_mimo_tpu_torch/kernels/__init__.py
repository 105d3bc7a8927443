"""Hand-written Hopper kernels (port of rub_mimo_tpu.kernels).

Each wrapper launches its CUDA kernel on CUDA tensors, takes its plain
PyTorch version only for CPU tensors, and counts its launches in an
integer attribute ``launches``.
"""
