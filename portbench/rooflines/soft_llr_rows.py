"""The soft-LLR rows kernel (rub_mimo_tpu_torch kernels/soft_llr.py::
soft_llr_rows): max-log LLRs written straight into the Viterbi's rows.

Bytes: the equalized symbols (complex64) read once, the rows' LLR pairs
(float32) written once.  Operations: a point's |y - c|^2 (5) and one
minimum a bit, then 2 bits scalings and bits subtractions a symbol."""

from portbench.rooflines import viterbi

KERNELS = ("soft_llr_rows_kernel",)


def bound(n_symbols: int, bits: int, n_rows: int, span: int):
    n_bytes = n_symbols * 8 + n_rows * span * 2 * 4
    flops = float(n_symbols) * ((5 + bits) * (1 << bits) + 3 * bits)
    return n_bytes, flops


def per_capture(ctx, pool_index):
    md = ctx.md
    n = md.n_sym * md.m_occ
    return bound(md.S * n, md.bits, *viterbi.rows(md.S, n, md.bits))
