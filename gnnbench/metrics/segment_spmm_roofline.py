"""Kernel `glt::segment_spmm`: its least time (bytes or operations) over its
device time in the traced eager steps, in %."""

from gnnbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "glt::segment_spmm")
