"""Kernel `glt::gat_block_backward` (Kernel 3's backward): its least time
(bytes or operations, ``flops_gat.block_backward``) over its device time
in the traced eager steps, in %."""

from gnnbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "glt::gat_block_backward")
