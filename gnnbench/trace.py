"""The traced part of a ``--trace 1`` run, and its reading.

Under one ``torch.profiler`` session the run replays the captured step a
few times (the idle share, the busy seconds, the device operations and the
host's activity in the idle gaps come from these replays), then runs K
steps eagerly with ``gnnbench.<layer>`` ranges around the calls into each
layer (device time goes to a layer by the range its launch falls in, and to
a kernel by the ``glt::`` operator's range on the launching thread).  The
trace is read from its Chrome export, written to a temporary file and
deleted.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


@dataclasses.dataclass
class TraceSummary:
    window_s: float               # the replays' host range
    busy_s: float                 # device activity inside it (union)
    replay_steps: int
    eager_steps: int
    span_device_s: Dict[str, float]     # eager: by gnnbench.<layer> range
    op_device_s: Dict[str, float]       # eager: by glt:: operator
    op_calls: Dict[str, int]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    unattributed_s: float


def record(step, replays: int) -> TraceSummary:
    """Trace ``replays`` replays of ``step``, then its K steps eagerly with
    spans and their ids kept (``step.traced``)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with record_function("gnnbench.replays"):
            for _ in range(replays):
                step()
            torch.cuda.synchronize()
        step.mode, step.spans = "trace", True
        with record_function("gnnbench.eager"):
            step.run_eager()
            torch.cuda.synchronize()
        step.mode, step.spans = None, False
    fd, path = tempfile.mkstemp(suffix=".json", prefix="gnnbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, replays * step.K, step.K)


def _innermost(ranges, ts: float):
    """The shortest (name, start, end) of ``ranges`` holding ``ts``."""
    best = None
    for name, t0, t1 in ranges:
        if t0 <= ts <= t1 and (best is None or t1 - t0 < best[2] - best[1]):
            best = (name, t0, t1)
    return best


def _union(intervals, lo: float, hi: float):
    """Merged [start, end] of ``intervals`` clipped to [lo, hi]."""
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: List[dict], replay_steps: int,
              eager_steps: int) -> TraceSummary:
    """Read a Chrome trace of :func:`record` (times in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in xs
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("gnnbench.")]
    by_name = {n: (a, b) for n, a, b in spans}
    r0, r1 = by_name["gnnbench.replays"]
    e0, e1 = by_name["gnnbench.eager"]
    layer_spans = [s for s in spans if s[0] not in ("gnnbench.replays",
                                                    "gnnbench.eager")]
    ops = collections.defaultdict(list)  # tid -> glt:: ranges
    op_calls = collections.Counter()
    for e in xs:
        if e.get("cat") == "cpu_op" and e["name"].startswith("glt::"):
            ops[e["tid"]].append((e["name"], e["ts"], e["ts"] + e["dur"]))
            if e0 <= e["ts"] <= e1:
                op_calls[e["name"]] += 1

    # the replays: busy, device operations, idle gaps by host activity
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev], r0, r1)
    busy_us = sum(b - a for a, b in busy)
    per_op = collections.Counter()
    for e in dev:
        if r0 <= e["ts"] <= r1:
            per_op[e["name"][:120]] += e["dur"] * 1e-6
    host = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in xs
            if e.get("cat") in LAUNCH_CATS + ("cpu_op", "user_annotation")
            and e["ts"] <= r1 and e["ts"] + e["dur"] >= r0]
    gaps = collections.Counter()
    edges = [r0] + [x for ab in busy for x in ab] + [r1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            hit = _innermost([h for h in host if h[0] != "gnnbench.replays"],
                             a)
            gaps[hit[0] if hit else "host: none"] += (b - a) * 1e-6

    # the eager steps: device time by layer range and by operator
    span_s = collections.Counter()
    op_s = collections.Counter()
    eager = sorted((e for e in dev if e0 <= e["ts"] <= e1),
                   key=lambda e: e["ts"])
    marks: List[Optional[Tuple[str, Optional[str]]]] = []
    for e in eager:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            marks.append(None)
            continue
        sp = _innermost(layer_spans, launch["ts"])
        op = _innermost(ops.get(launch["tid"], []), launch["ts"])
        marks.append((sp[0] if sp else None, op[0] if op else None))
    unattributed = 0.0
    for i, e in enumerate(eager):
        mark = marks[i]
        if mark is None:  # between two launches of one range: that range
            prev = next((m for m in reversed(marks[:i]) if m), None)
            nxt = next((m for m in marks[i + 1:] if m), None)
            mark = prev if prev == nxt else None
        s = e["dur"] * 1e-6
        if mark is None:
            unattributed += s
            continue
        if mark[0]:
            span_s[mark[0][len("gnnbench."):]] += s
        if mark[1]:
            op_s[mark[1]] += s
    return TraceSummary(
        window_s=(r1 - r0) * 1e-6, busy_s=busy_us * 1e-6,
        replay_steps=replay_steps, eager_steps=eager_steps,
        span_device_s=dict(span_s), op_device_s=dict(op_s),
        op_calls=dict(op_calls), device_ops=per_op.most_common(TOP),
        idle_gaps=gaps.most_common(TOP), unattributed_s=unattributed)
