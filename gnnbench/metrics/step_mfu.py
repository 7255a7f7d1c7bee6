"""Step loop: a step's least time by its operations over the device's busy
time a step in the traced replays, in %."""

from gnnbench import flops


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0 or not t.replay_steps:
        return None
    return 100.0 * flops.compute_s(ctx.step_work, ctx.peaks) / (
        t.busy_s / t.replay_steps)
