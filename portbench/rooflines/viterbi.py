"""The Viterbi kernel (rub_mimo_tpu_torch kernels/viterbi.py) over the
rows of a rate-1/2 coded decode.

Rows as the decode lays them out: a codeword of T = n_msg + 6 steps a
lane in windows of 4096 steps with 128 of margin each side past 4 x 4096
steps, else one row of T.  Bytes: the rows' LLR pairs (float32) and
pinned flags read, the decided bits (int32 a step) written.  Operations:
6 a state and step (the branch metric's add, shared four ways and
counted once, the candidate add, the compare, the select, the max and
the renormalizing subtract), 64 states; the windows' overlap counted."""

KERNELS = ("viterbi_kernel",)
OPS_PER_STATE_STEP, STATES = 6, 64


def rows(lanes: int, symbols_per_lane: int, bits: int):
    """(rows, steps a row) of the decode's plan at rate 1/2."""
    T = symbols_per_lane * bits // 2
    if T > 4 * 4096:
        return lanes * -(-T // 4096), 4096 + 2 * 128
    return lanes, T


def bound(n_rows: int, span: int):
    n_bytes = n_rows * span * 2 * 4 + n_rows + n_rows * span * 4
    return n_bytes, float(OPS_PER_STATE_STEP * STATES * n_rows * span)


def per_capture(ctx, pool_index):
    md = ctx.md
    return bound(*rows(md.S, md.n_sym * md.m_occ, md.bits))
