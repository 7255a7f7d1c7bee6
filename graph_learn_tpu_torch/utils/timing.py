"""Timing of work on the card with CUDA events.

Used by the measurement harnesses (``examples/sweep_aggregate.py``,
``chip_smoke.py``).  Nothing here runs on a CPU tensor path: the callers
time CPU runs on the host clock and say so.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Optional

import torch


def time_ms(fn: Callable[[], object], iters: int = 50, warmup: int = 5,
            hold: bool = False,
            log: Optional[Callable[[str], None]] = None) -> float:
    """Mean time of one call over ``iters`` back-to-back calls, between two
    CUDA events.  Without ``hold`` the host launches as the card runs, so a
    call that is quicker on the card than on the host is timed at the
    host's launch rate.  With ``hold`` the stream first spins while the host
    queues every call, so the result is the card's time alone.  The spin
    starts at about 20 ms; when the host took longer than the spin to queue
    the calls (a slow or busy host), the measurement is taken again with a
    spin of twice the host's queueing time, and a RuntimeError is raised if
    three tries never held the card.  Keep ``iters`` times the launches of
    one call well below the CUDA launch queue's depth (about a thousand),
    or the host blocks on the full queue whatever the spin."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin_cycles = 40_000_000
    tries = []
    for _ in range(3 if hold else 1):
        held = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            held.record()
            torch.cuda._sleep(spin_cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if not hold:
            return start.elapsed_time(end) / iters
        spin_ms = held.elapsed_time(start)
        if enqueue_ms < spin_ms:
            return start.elapsed_time(end) / iters
        tries.append("%.2f ms to queue, %.2f ms spin" % (enqueue_ms, spin_ms))
        if log is not None:
            log("timing: the host took %s; again with a longer spin"
                % tries[-1])
        spin_cycles = int(spin_cycles * 2.0 * enqueue_ms / spin_ms)
    raise RuntimeError("timing: the host took longer to queue %d calls than "
                       "the card spun, in every try: %s"
                       % (iters, "; ".join(tries)))


def time_cold_ms(fn: Callable[[], object], iters: int = 20) -> float:
    """Median device time of one call after the L2 was flushed (a 256 MiB
    write, over five times the H100's 50 MB L2), one call per pair of
    events.  The stream spins between the flush and the first event while
    the host queues the call, so the time is the card's alone and not the
    host's launch gap; a call the host took longer to queue than the spin
    is timed again with a spin of twice the host's queueing time, and a
    RuntimeError is raised if three tries of one call never held the
    card."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    spin_cycles = 4_000_000
    times = []
    for _ in range(iters):
        tries = []
        while True:
            flush.zero_()
            held = torch.cuda.Event(enable_timing=True)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            held.record()
            torch.cuda._sleep(spin_cycles)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            end.synchronize()
            spin_ms = held.elapsed_time(start)
            if enqueue_ms < spin_ms:
                times.append(start.elapsed_time(end))
                break
            tries.append("%.2f ms to queue, %.2f ms spin"
                         % (enqueue_ms, spin_ms))
            if len(tries) == 3:
                raise RuntimeError("timing: the host took longer to queue "
                                   "one call than the card spun, in every "
                                   "try: %s" % "; ".join(tries))
            spin_cycles = int(spin_cycles * 2.0 * enqueue_ms / spin_ms)
    return float(statistics.median(times))
