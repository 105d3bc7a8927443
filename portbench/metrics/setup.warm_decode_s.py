"""Seconds of set-up in the serving graph's warm decodes
(``setup.warm_decode``, WARMUP_DECODES of them before the capture, host
time), the kernels' loads inside them (``setup.kernel_load``) left out:
the part of ``setup.graph_s`` that fewer or cheaper warm decodes would
cut.  None where the program keeps no set-up spans."""

from portbench import spans


def read(ctx):
    return spans.setup_s(ctx, "setup.warm_decode")
