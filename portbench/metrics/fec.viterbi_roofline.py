"""The Viterbi kernel's share of its roofline over the traced captures
(rooflines/viterbi.py)."""

from portbench import roofline


def read(ctx):
    return roofline.share(ctx, "viterbi")
