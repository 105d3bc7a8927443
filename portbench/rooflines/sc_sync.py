"""K5, the one-pass Schmidl & Cox sync (rub_mimo_tpu_torch
kernels/sc_sync.py): its scan and its resolve.

What a capture needs is the samples up to the fire t*, not the whole
capture: bytes S (t* + 1) complex64 samples read once; operations the
metric's ~18 a sample and stream.  t* is the plain receiver's, from the
capture itself.  The counters' memset before the scan is a copy layer's
(``layers/serving.json``), not counted here."""

KERNELS = ("sc_sync_scan", "sc_sync_resolve")


def bound(S: int, t_star: int):
    n = S * (t_star + 1)
    return n * 8, 18.0 * n


def per_capture(ctx, pool_index):
    return bound(ctx.md.S, ctx.t_star[pool_index])
