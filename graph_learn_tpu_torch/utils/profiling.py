"""Profiling: host scope timers and device traces.

Counterpart of ``graph_learn_tpu/utils/profiling.py:26-46``: ``profiling``
accumulates the host seconds and count of each key and ``dump`` prints
them (once more at exit), as the reference's PROFILING macro does;
``device_trace`` records a ``torch.profiler`` trace of the CPU and, where
there is one, the card, written as a Chrome trace into ``logdir``; and
``annotate`` names a region of that trace
(``torch.profiler.record_function``).
"""

from __future__ import annotations

import atexit
import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict

import torch

_stats: Dict[str, list] = defaultdict(lambda: [0.0, 0])
_dump_registered = False


@contextlib.contextmanager
def profiling(key: str):
    """Host scope timer: adds the scope's seconds and one call to ``key``."""
    global _dump_registered
    if not _dump_registered:
        atexit.register(dump)
        _dump_registered = True
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _stats[key][0] += dt
        _stats[key][1] += 1


def dump():
    """Print the total seconds, count and mean ms of every key."""
    for key, (total, count) in sorted(_stats.items()):
        print("[profiling] %s: total %.3fs, count %d, avg %.3fms"
              % (key, total, count, 1000.0 * total / max(count, 1)))


@contextlib.contextmanager
def device_trace(logdir: str = ""):
    """Record a ``torch.profiler`` trace of the scope (the CPU, and the
    card when there is one) into ``logdir/trace.json`` (default: a
    ``glt_trace`` folder in the temporary directory); yields the profiler,
    whose ``key_averages()`` the caller may read."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "glt_trace")
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named region of the device trace."""
    return torch.profiler.record_function(name)
