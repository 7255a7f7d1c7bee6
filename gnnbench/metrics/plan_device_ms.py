"""Plan: device ms a step of the GSL plan (seeds, sampling, lookups),
from the traced eager steps."""

from gnnbench.readers import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "plan")
