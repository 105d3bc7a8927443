"""The soft-LLR rows kernel's share of its roofline over the traced
captures (rooflines/soft_llr_rows.py)."""

from portbench import roofline


def read(ctx):
    return roofline.share(ctx, "soft_llr_rows")
