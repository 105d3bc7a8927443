"""Sharded and batched decoding over a device mesh (port of
rub_mimo_tpu/parallel)."""
