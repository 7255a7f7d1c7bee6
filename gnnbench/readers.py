"""What the per-layer readers (``metrics/<name>.py``) share.

A reader is ``read(ctx) -> float | None``: None where the run has nothing
for it to read (no trace, or its kernel not on this cell's path), and the
harness then leaves the metric out of the result line.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from gnnbench import flops
from gnnbench.trace import TraceSummary


@dataclasses.dataclass
class Context:
    """What a run hands its readers."""

    trace: Optional[TraceSummary]
    step_work: flops.Work                 # one training step
    kernel_work: Dict[str, List[flops.Work]]  # by operator, traced steps
    peaks: dict
    store_build_s: float


def per_step_ms(ctx: Context, layer: str) -> Optional[float]:
    """Device ms a traced eager step in ``gnnbench.<layer>`` ranges."""
    t = ctx.trace
    if t is None or layer not in t.span_device_s:
        return None
    return t.span_device_s[layer] / t.eager_steps * 1e3


def roofline_pct(ctx: Context, op: str) -> Optional[float]:
    """The least time of operator ``op``'s launches in the traced steps
    over their device time, in %; None unless every launch the cell's
    model expects was traced, and no other."""
    t = ctx.trace
    works = ctx.kernel_work.get(op)
    if t is None or not works or t.op_calls.get(op, 0) != len(works):
        return None
    device_s = t.op_device_s.get(op, 0.0)
    if device_s <= 0:
        return None
    least = sum(flops.least_s(w, ctx.peaks) for w in works)
    return 100.0 * least / device_s
