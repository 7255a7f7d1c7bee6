"""Kernel `glt::gat_block` (Kernel 3's forward): its least time (bytes or
operations, ``flops_gat.block_forward``) over its device time in the
traced eager steps, in %."""

from gnnbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "glt::gat_block")
