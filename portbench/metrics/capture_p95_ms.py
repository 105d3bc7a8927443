"""The 95th percentile of every capture's device latency in the window
(CUDA events before its input copy and after its last output), over all
captures (linear between ranks)."""

import numpy as np


def read(ctx):
    lat = ctx.window["latencies_ms"]
    return float(np.percentile(np.asarray(lat, np.float64), 95)) if lat \
        else None
