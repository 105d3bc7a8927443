"""K1, the payload tail in one kernel: CP strip, M-point FFT, equalize,
hard demap (rub_mimo_tpu_torch kernels/payload_fused.py).

Bytes: the payload planes' kept samples (the CP's whole 32-byte sectors
are never read), the equalizer W and its gain, and the decisions (int32)
with the equalized symbols (complex64) when the decode keeps them.
Operations: a radix-2 FFT (5 M log2 M a row), the S x S complex equalize
(8 a multiply-add, 2 for the gain) and the demap (4 a point)."""

import math

KERNELS = ("payload_fused_strip_kernel",)


def bound(S: int, n_sym: int, M: int, points: int, emit_sig: bool = True):
    n_bytes = (2 * S * n_sym * M * 4 + M * S * S * 8 + M * 4
               + S * n_sym * M * ((8 if emit_sig else 0) + 4))
    flops = S * n_sym * M * (8 * S + 2 + 4 * points + 5 * math.log2(M))
    return n_bytes, float(flops)


def per_capture(ctx, pool_index):
    md = ctx.md
    return bound(md.S, md.n_sym, md.M, 1 << md.bits,
                 ctx.config["port"]["keep_rx_sig"])
