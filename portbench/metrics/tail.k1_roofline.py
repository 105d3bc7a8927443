"""K1's share of its roofline over the traced captures
(rooflines/payload_fused_strip.py)."""

from portbench import roofline


def read(ctx):
    return roofline.share(ctx, "payload_fused_strip")
