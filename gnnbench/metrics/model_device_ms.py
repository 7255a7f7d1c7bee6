"""Model: device ms a step of the forward, the loss, the backward and Adam
(Kernel 1 and Kernel 3 included), from the traced eager steps."""

from gnnbench.readers import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "model")
