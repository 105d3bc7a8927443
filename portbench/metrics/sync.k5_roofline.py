"""K5's share of its roofline over the traced captures: bytes and
operations up to each capture's t* (rooflines/sc_sync.py)."""

from portbench import roofline


def read(ctx):
    return roofline.share(ctx, "sc_sync")
