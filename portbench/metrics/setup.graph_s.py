"""Seconds of set-up in the serving graph's build (``setup.graph``: its
two warm decodes and its capture), the kernels' loads inside it
(``setup.kernel_load``) left out.  None where the program keeps no
set-up spans."""

from portbench import spans


def read(ctx):
    return spans.setup_s(ctx, "setup.graph")
