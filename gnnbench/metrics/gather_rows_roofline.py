"""Kernel `glt::gather_rows`: its least time (bytes or operations) over its
device time in the traced eager steps, in %."""

from gnnbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "glt::gather_rows")
