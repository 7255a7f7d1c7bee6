#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (graph_learn_tpu_torch).

Run from the repository root on a machine with one NVIDIA card (H100):

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from graph_learn_tpu_torch/csrc with nvcc, one
   process per source, all at once, and print the build time and the
   ptxas register report;
3. hold each kernel against its plain PyTorch version on the card, over
   dtypes, widths, ragged sizes and degrees (the GAT block: forward and
   every gradient, at small sizes on both routes of its products, at the
   training path's full first-layer size and at a deep reduction; the
   segment SpMM kernel also on ids and degrees out of range, which it
   clips itself, and with a raw max/min, on which a group max keeps inf,
   -inf and NaN as the JAX package does; the gather kernel bit for bit on
   both its routes, even and odd tables and a view; the sweep kernel with
   its prep's invariants), and time kernel, plain version and, where one
   PyTorch call computes the same function, that call, at the main paths'
   shapes (the gather kernel at 1 024, 15 360 and 153 600 rows, the row
   counts the paths launch, with one kernel a call), checking with
   torch.profiler that one call of the segment SpMM wrapper puts one
   kernel on the card (the sweep wrapper: one kernel and one memset, each
   timed from the profiler's events); the GAT block also part by part
   (attention passes, each product on the tensor cores and on the f32 FMA
   route, the forward's also on mma.sync beside wgmma, the tail);
4. run the serving path at the benchmark's width: the 200k-node / 3.2M-edge
   synthetic graph with bf16 features, the 2-hop EgoSAGE query installed on
   QueryService(micro_batch=1024), several client threads sending raw-id
   requests, and EgoGraphSAGE([128, 256, 32], agg "gcn") on every answer:
   the rows of the source and first hop gathered by the gather kernel, the
   deepest hop reduced by the segment SpMM kernel.  Sampled ids, features
   and logits are checked, and both kernels' launch counters must have
   moved during this phase;
5. show where one caller's request goes: the host wall of the request and
   of the forward, and the device time by kernel (torch.profiler);
6. run the training path on the same graph through LocalTrainer.train
   (shuffle source, batch 1024, Adam 1e-3): EgoGraphSAGE([128, 256, 32],
   "gcn") with the deepest hop pre-aggregated outside the gradient, then
   EgoGAT([128, 256, 32], num_heads=[8, 1]) with every neighbour block on
   the GAT kernel, forward and backward, its products on the tensor cores
   and the first layer's forward products on wgmma (checked).  For each:
   one step's loss and gradients against the same step on the plain
   versions, every loss finite, parameters moved, launch counters as
   expected, edges/s and the device-busy share of a step;
7. answer a "full" sampling query (cap 32) on the same graph through
   QueryService and reduce its SparseNodes with the segment SpMM kernel on
   ragged degrees; check an edge_weight and a topk query for true
   neighbours (topk: the heaviest edges first);
8. run the sweep-aggregate harness (examples/sweep_aggregate.py) at its
   full shape, 2 457 600 x 128 f32 with 153 600 hits in groups of 10: bar,
   prep, stream, sweep and total, then the sweep and stream kernels, their
   plain versions and the library call on the same shape, the sweep's
   zero fill and kernel apart;
9. run the 62M-edge frontier path (examples/scale_demo.py) at the published
   sizes, 2 450 000 nodes, 62 000 000 edges, 100 bf16 features, batch 1024,
   fanout [15, 10], EgoGraphSAGE([100, 256, 47]), steps cut to 30 after 3
   of warm-up: host build seconds, bytes on the card, one step against the
   plain versions, step wall, edges/s, device-busy share and launches per
   step; the same run with conf.sorted_gather on (the deepest hop on the
   sweep kernel instead of the segment SpMM kernel), its first-step loss
   held to the unsorted run's, the two routes run in the order unsorted,
   sorted, sorted, unsorted because the host clock drifts; and the
   kernels' times at that table, warm (repeated calls on the same ids)
   and cold (the L2 flushed before each call);
10. answer ``.outV("rel").sample(15).by(s).filter("src")`` through
   QueryService on the 200k graph for random, topk, edge_weight and full,
   on every node that links to itself and 1 000 others: every id a true
   neighbour, and no hop-1 id equal to its seed in a row that holds
   another neighbour (without the filter the seeds do come back);
11. run the port bench (graph_learn_tpu_torch/bench.py run_bench) at
   bench.py's CFG on the same 200k graph (120 steps after 2 warm-up
   calls of K = 30) and at CFG_SCALE on the weighted 61.25M-edge graph it
   builds under the "minimal" profile (60 steps after 1 call of K = 20),
   each eager and then with the K steps in one captured CUDA graph: every
   step's loss bit-equal between the two, the same parameters after, two
   replays with other seeds and losses, 2 gather_rows and 1 segment_spmm
   per replayed step from torch.profiler (at CFG also a captured run
   under conf.sorted_gather: 2 gather_rows and 1 sweep_aggregate), step
   wall, edges/s, device-busy share, capture seconds, graph-pool bytes,
   host build seconds and peak bytes on the card.

The last two lines of standard output are the card line and the JSON
object {"ok": true, "device": {...}}; the {"kernels": [...]} line comes
just before them.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, the f32 rate
# outside the tensor cores and the tensor cores' dense TF32 rate, for the
# kernels' least possible time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_TF32_OPS_PER_S = 495e12

# Benchmark configuration of the serving path (bench.py CFG).
N_NODES, AVG_DEGREE, FEAT_DIM, HIDDEN, CLASSES = 200_000, 16, 128, 256, 32
FANOUT = (15, 10)
MICRO_BATCH = 1024
N_CLIENTS, REQUESTS_PER_CLIENT = 8, 16
# Training: steps per measured run (SAGE: two epochs of 20) and Adam's rate
SAGE_EPOCHS, SAGE_STEPS, GAT_STEPS, LEARNING_RATE = 2, 20, 10, 1e-3
GAT_HEADS = (8, 1)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print("[chip_smoke] " + msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=50, warmup=5, hold=False) -> float:
    """Mean card time of one call (utils/timing.py time_ms: with ``hold``
    the stream spins while the host queues the calls)."""
    from graph_learn_tpu_torch.utils import timing
    return timing.time_ms(fn, iters=iters, warmup=warmup, hold=hold, log=log)


def time_cold_ms(fn, iters=20) -> float:
    """Median device time of one call after an L2 flush (utils/timing.py)."""
    from graph_learn_tpu_torch.utils import timing
    return timing.time_cold_ms(fn, iters=iters)


def bound(n_bytes: float, n_ops: float, n_tensor_ops: float = 0.0):
    """Least ms for the work: bytes over the memory rate, or the f32
    operations over the CUDA cores' peak plus the matrix-product operations
    (counted once, whatever passes a kernel makes) over the TF32 peak."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (n_ops / PEAK_F32_OPS_PER_S
             + n_tensor_ops / PEAK_TF32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profiled_work(torch, fn, calls):
    """[(start, name, us)] of the work on the card (kernels and memsets,
    whoever launches them) in the second of two windows of ``calls`` calls
    of ``fn`` under torch.profiler (the first warms the profiler up), in
    launch order."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return sorted((ev.time_range.start, ev.name,
                   ev.time_range.end - ev.time_range.start)
                  for ev in prof.events()
                  if (str(getattr(ev, "device_type", "")).endswith("CUDA")
                      and not getattr(ev, "is_user_annotation", False)
                      and not ev.name.startswith("ProfilerStep")))


def device_work_per_call(torch, fn, calls=10, tries=3):
    """({name: count per call}, {name: mean device ms of one launch}) of the
    work ``fn`` puts on the card (kernels and memsets, whoever launches
    them), under torch.profiler: a first window of ``calls`` calls warms the
    profiler up, a second is counted.  A wrapper launches the same kernels
    at every call, so a counted window whose kernel counts are no whole
    multiples of ``calls`` lost records (one window recorded nothing at
    all): it is profiled again, up to ``tries`` times.  Memsets count as
    recorded (the profiler has dropped one in ten)."""
    for _ in range(tries):
        counts, us = {}, {}
        for _, name, dur in profiled_work(torch, fn, calls):
            counts[name] = counts.get(name, 0) + 1
            us[name] = us.get(name, 0.0) + dur
        if counts and all(n % calls == 0 for name, n in counts.items()
                          if not name.startswith("Memset")):
            return ({name: n / calls for name, n in counts.items()},
                    {name: us[name] / n / 1e3 for name, n in counts.items()})
        log("torch.profiler recorded %s over %d calls; profiling again"
            % (counts, calls))
    check(False, "torch.profiler recorded no whole calls in %d windows: %s"
          % (tries, counts))


def check_one_launch(torch, what, fn, kernel, allow_memset=False):
    """One call of ``fn`` puts exactly one ``kernel`` on the card, and at
    most one memset where ``allow_memset``: no clamp, cast or fill kernel
    beside it.  Returns ({"kernel" or "memset": count per call}, {the same:
    mean device ms of one})."""
    work, ms = device_work_per_call(torch, fn)
    kernels = {n: c for n, c in work.items() if kernel in n}
    others = {n: c for n, c in work.items() if kernel not in n}
    memsets = {n: c for n, c in others.items() if n.startswith("Memset")}
    check(list(kernels.values()) == [1.0] and (
        others == {} or (allow_memset and others == memsets
                         and sum(memsets.values()) <= 1.0)),
          "%s: one call put %s on the card; want one %s%s" % (
              what, work, kernel, " and at most one memset"
              if allow_memset else " and nothing else"))

    def part(n):
        return "memset" if n.startswith("Memset") else "kernel"
    return ({part(n): c for n, c in work.items()},
            {part(n): t for n, t in ms.items()})


def check_bounds(rows):
    """No time on the kernels line reads under the least time it is held
    to: ``ms`` under ``bound_ms``, the backward, the harness bar, the
    cold call at the 62M table and Kernel 1's cold calls at the row counts
    the paths launch (``ms_1024`` under ``bound_ms_1024``,
    ``cold_ms_62m_15360`` under ``bound_ms_62m_15360``, ...).  The bounds
    count device-memory bytes, so the times held to them are those of
    calls whose rows come from device memory: cold where the rows fit the
    L2 (Kernels 1 and 2 at the 200k table), and the warm figures
    (``warm_ms``, ``ms_62m``) are not held.
    Raises SmokeFailure naming each time that reads under its bound."""
    pairs = (("ms", "bound_ms"), ("bwd_ms", "bwd_bound_ms"),
             ("bar_ms", "bar_bound_ms"), ("cold_ms_62m", "bound_ms_62m"))
    pairs += tuple(pair for m in GATHER_PATH_ROWS for pair in (
        ("ms_%d" % m, "bound_ms_%d" % m),
        ("cold_ms_62m_%d" % m, "bound_ms_62m_%d" % m)))
    under = ["%s %s %.4f < %.4f" % (r["name"], t, r[t], r[b])
             for r in rows for t, b in pairs
             if t in r and b in r and r[t] < r[b]]
    check(not under, "times under their bound (a bound that counts too "
          "many bytes, or a time that does not cover the work): %s"
          % "; ".join(under))


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


GATHER_ROWS = (1, 31, 32, 33, 4097, 15_360, 153_600)


def check_gather(torch, gather):
    """Kernel 1 bit for bit against gather_rows_plain on every route it
    takes: D in {128, 100, 64, 7}, bf16 and f32, ragged row counts, ids 0
    and N - 1 and repeated ids, on an even table, an odd one (a 200-byte
    row's 16-byte covering span runs past the last row) and a contiguous
    view ``base[1:]`` whose base lies one row into its storage (only 8-byte
    aligned at D = 100 bf16, 2-byte at D = 7 bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for d in (128, 100, 64, 7):
            base = torch.randn((20_002, d), generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
            tables = (("even", base[:20_000].clone()),
                      ("odd", base[:20_001].clone()),
                      ("view base[1:]", base[1:]))
            for label, table in tables:
                n = table.shape[0]
                for m in GATHER_ROWS:
                    idx = torch.randint(0, n, (m,), generator=gen,
                                        device="cuda", dtype=torch.int32)
                    idx[0] = n - 1
                    idx[m // 2] = 0
                    idx[m // 3:m // 3 + min(m, 40) // 4] = n - 1  # repeats
                    out = gather.gather_rows(table, idx)
                    torch.cuda.synchronize()
                    check(torch.equal(out, gather.gather_rows_plain(table,
                                                                    idx)),
                          "gather_rows != plain (%s, D=%d, M=%d, %s table "
                          "of %d rows)" % (dtype, d, m, label, n))
                    cases += 1
    log("gather_rows: %d cases bit for bit against gather_rows_plain: "
        "bf16/f32, D in {128, 100, 64, 7}, M in %s, ids 0 and N-1 and "
        "repeated, even and odd tables and a view base[1:]"
        % (cases, list(GATHER_ROWS)))


# Kernel 1's row counts on the paths besides the 153 600-row GAT hop 2:
# src (1 024) and hop 1 (15 360) of every serving forward, SAGE step and
# 62M step
GATHER_PATH_ROWS = (1_024, 15_360)


def gather_kernels(torch, calls, where, tries=3):
    """The kernel that each of ``calls`` (gather_rows calls) puts on the
    card, from one torch.profiler session over all of them in turn: each
    must put exactly one kernel named gather_rows on the card, the same at
    every repeat.  Its name says the route, ``bulk`` or the lane groups."""
    n, reps = len(calls), 10
    for _ in range(tries):
        names = [name for _, name, _ in profiled_work(
            torch, lambda: [c() for c in calls], reps)]
        if len(names) == n * reps:
            check(all(name == names[i % n] and "gather_rows" in name
                      for i, name in enumerate(names)),
                  "gather_rows %s: a call put %s on the card; want one "
                  "gather_rows kernel a call" % (where, names[:n]))
            return names[:n]
        log("torch.profiler recorded %d kernels over %d x %d gather_rows "
            "calls; profiling again" % (len(names), reps, n))
    check(False, "gather_rows %s: torch.profiler recorded %s over %d x %d "
          "calls, in %d windows; want one gather_rows kernel a call"
          % (where, names[:3 * n], reps, n, tries))


def gather_shapes(torch, gather, table, gen, where, rows=GATHER_PATH_ROWS,
                  warm_rows=(), given=None, yardsticks=()):
    """Kernel 1 at ``rows`` random rows of ``table`` (the ids in ``given``
    [m] where it has them): exact against the plain version, one kernel a
    call (``gather_kernels``; its route, ``bulk`` or ``lanes``), the cold
    time (L2 flushed, stream held) and its bound (each row read once and
    written once, plus the ids); warm (50 calls on the same ids) where
    ``m`` is in ``warm_rows``; the plain version and ``index_select`` cold
    where it is in ``yardsticks``.  Returns {m: fields}."""
    n, d = table.shape
    ids = {}
    for m in rows:
        ids[m] = (given or {}).get(m)
        if ids[m] is None:
            ids[m] = torch.randint(0, n, (m,), generator=gen, device="cuda",
                                   dtype=torch.int32)
        check(torch.equal(gather.gather_rows(table, ids[m]),
                          gather.gather_rows_plain(table, ids[m])),
              "gather_rows %s, %d rows, differs from table[idx]" % (where, m))
    kernels = gather_kernels(torch, [
        (lambda i=ids[m]: gather.gather_rows(table, i)) for m in rows], where)
    res = {}
    for m, name in zip(rows, kernels):
        def call(i=ids[m]):
            return gather.gather_rows(table, i)
        moved = 2 * m * d * table.element_size() + 4 * m
        f = dict(ms=time_cold_ms(call), bound_ms=bound(moved, 0)[0],
                 route="bulk" if "bulk" in name else "lanes")
        if m in warm_rows:
            f["warm_ms"] = time_ms(call, hold=True)
        if m in yardsticks:
            f["plain_ms"] = time_cold_ms(
                lambda i=ids[m]: gather.gather_rows_plain(table, i))
            f["library_ms"] = time_cold_ms(
                lambda i=ids[m]: torch.index_select(table, 0, i))
        log("gather_rows %s, %d rows (%.3f MB moved): %.4f ms cold%s, bound "
            "%.4f (%.1f%%), one kernel a call on the %s route (%s)%s"
            % (where, m, moved / 1e6, f["ms"], ", %.4f warm" % f["warm_ms"]
               if "warm_ms" in f else "", f["bound_ms"],
               100 * f["bound_ms"] / f["ms"], f["route"], name[:60],
               "; plain %.4f, index_select %.4f, both cold"
               % (f["plain_ms"], f["library_ms"]) if "plain_ms" in f
               else ""))
        res[m] = f
    return res


def check_spmm(torch, spmm):
    """Kernel 2 against segment_spmm_plain over dtypes, widths, aggregations
    and ragged degrees, then on ids and degrees out of range (negative, past
    the table, past cap), which the kernel clips itself, and on int64 ids
    and degrees, which the wrapper clips and casts."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, cap, n = 777, 10, 5_000
    worst = 0.0
    cases = 0
    for in_dtype in (torch.bfloat16, torch.float32):
        for out_dtype in (torch.float32, in_dtype):
            # f32 out: only the order of the f32 sums differs; bf16 out:
            # that difference may flip one bf16 rounding (2^-8 relative)
            rtol, atol = ((1e-5, 1e-5) if out_dtype == torch.float32
                          else (2 ** -7, 1e-5))
            for d in (128, 100):
                feats = torch.randn((n, d), generator=gen, device="cuda",
                                    dtype=torch.float32).to(in_dtype)
                ids = torch.randint(0, n, (b, cap), generator=gen,
                                    device="cuda", dtype=torch.int32)
                deg = torch.randint(0, cap + 1, (b,), generator=gen,
                                    device="cuda", dtype=torch.int32)
                deg[:3] = torch.tensor([0, cap, 1], dtype=torch.int32)
                # out of range: negative ids, ids past the table, degrees
                # under 0 and over cap
                bad_ids = ids.clone()
                bad_ids[::7, 0] = -3
                bad_ids[1::7, cap - 1] = n + 17
                bad_ids[2::11, 3] = -(2 ** 31)
                bad_ids[3::11, 2] = 2 ** 31 - 1
                bad_deg = deg.clone()
                bad_deg[::5] = -4
                bad_deg[1::5] = cap + 6
                inputs = (("in range", ids, deg),
                          ("out of range", bad_ids, bad_deg),
                          ("int64", bad_ids.long(), bad_deg.long()))
                for agg in spmm.AGGS:
                    for label, i, dg in inputs:
                        out = spmm.segment_spmm(feats, i, dg, agg, out_dtype)
                        ref = spmm.segment_spmm_plain(
                            feats, *spmm.clip(i, dg, n), agg, out_dtype)
                        torch.cuda.synchronize()
                        check(out.dtype == out_dtype and out.shape == (b, d),
                              "segment_spmm dtype/shape")
                        ok = torch.allclose(out.float(), ref.float(),
                                            rtol=rtol, atol=atol)
                        err = (out.float() - ref.float()).abs().max().item()
                        check(ok, "segment_spmm %s %s->%s D=%d, ids and "
                              "degrees %s: max err %g"
                              % (agg, in_dtype, out_dtype, d, label, err))
                        worst = max(worst, err)
                        cases += 1
    log("segment_spmm: %d cases, sum/mean/max/min, bf16/f32 in, "
        "f32/in-dtype out, D in {128, 100}, degrees 0..cap, then ids < 0 and "
        ">= N and degrees < 0 and > cap (clipped by the kernel), and int64 "
        "ids and degrees, within tolerance of segment_spmm_plain on the "
        "clipped inputs (f32 out rtol=atol=1e-5; bf16 out rtol=2^-7, "
        "atol=1e-5); max abs err %g" % (cases, worst))


def same_values(torch, a, b):
    """Equal element by element, NaN where the other has NaN."""
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def check_group_max(torch, gl, spmm):
    """A group max keeps inf, -inf and NaN (the JAX package's jnp.max and
    segment_max): gather_group_agg(max) on rows holding them against the
    plain ``table[idx].amax(1)``, with conf.sorted_gather off and on (each
    one Kernel 2 launch); then Kernel 2's raw max/min against
    segment_spmm_plain(raw_extrema=True) on ragged degrees, an empty row
    among them (-inf / +inf), and its pinned rule (0) beside it."""
    from graph_learn_tpu_torch.ops.aggregate import gather_group_agg
    gen = torch.Generator(device="cuda").manual_seed(4)
    n, k, groups = 5_000, 10, 1_537
    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for d in (128, 100):
            table = torch.randn((n, d), generator=gen, device="cuda",
                                dtype=torch.float32)
            table[::97, ::7] = float("inf")
            table[1::89, 3::5] = float("nan")
            table[2::83, 1::3] = float("-inf")
            table[7] = float("-inf")
            table = table.to(dtype)
            idx = torch.randint(0, n, (groups, k), generator=gen,
                                device="cuda", dtype=torch.int32)
            idx[0] = 7  # a group of -inf rows
            want = table[idx.long()].float().amax(1)
            check(bool(torch.isinf(want).any() and torch.isnan(want).any()),
                  "group max: the inputs hold no non-finite result")
            saved = (gl.conf.sorted_gather, gl.conf.sorted_gather_min_bytes)
            for sorted_on in (False, True):
                gl.conf.sorted_gather = sorted_on
                gl.conf.sorted_gather_min_bytes = 0
                before = spmm.LAUNCHES.count
                try:
                    out = gather_group_agg(table, idx, "max")
                finally:
                    gl.conf.sorted_gather, gl.conf.sorted_gather_min_bytes = \
                        saved
                torch.cuda.synchronize()
                check(spmm.LAUNCHES.count == before + 1
                      and same_values(torch, out, want),
                      "gather_group_agg(max) on non-finite rows, %s D=%d, "
                      "sorted_gather=%s: differs from table[idx].amax(1)"
                      % (dtype, d, sorted_on))
                cases += 1
            deg = torch.randint(0, k + 1, (groups,), generator=gen,
                                device="cuda", dtype=torch.int32)
            deg[:2] = torch.tensor([0, k], dtype=torch.int32)
            for agg in ("max", "min"):
                for raw in (True, False):
                    out = spmm.segment_spmm(table, idx, deg, agg,
                                            torch.float32, raw_extrema=raw)
                    ref = spmm.segment_spmm_plain(table, idx, deg, agg,
                                                  torch.float32, raw)
                    torch.cuda.synchronize()
                    check(same_values(torch, out, ref)
                          and (raw or bool(torch.isfinite(out).all())),
                          "segment_spmm %s raw_extrema=%s on non-finite "
                          "rows, %s D=%d: differs from the plain version"
                          % (agg, raw, dtype, d))
                    cases += 1
    log("group max: %d cases equal (NaN where NaN): gather_group_agg(max) "
        "on rows holding inf, -inf and NaN against table[idx].amax(1), "
        "sorted_gather off and on, one segment_spmm launch a call; "
        "segment_spmm max/min with raw_extrema on and off against the plain "
        "version on ragged degrees" % cases)


def sweep_case(torch, sweep, table, flat, k, R):
    """One Kernel 4 case: sweep_prep's hit list held to its invariants, then
    sweep_aggregate against sweep_aggregate_plain at rtol = atol = 1e-5 (k
    f32 terms a group, added in an order that changes from run to run);
    returns the max abs error."""
    n_rows, d = table.shape
    n = flat.shape[0]
    groups = n // k
    starts, packed = sweep.sweep_prep(flat, k, n_rows, R)
    n_slabs = -(-n_rows // R)
    check(starts.shape == (n_slabs + 1,) and packed.shape == (n,)
          and starts.dtype == packed.dtype == torch.int32,
          "sweep_prep shapes/dtypes")
    check(int(starts[0]) == 0 and int(starts[-1]) == n
          and bool((starts[1:] >= starts[:-1]).all()),
          "sweep_prep: starts do not run from 0 to N")
    rows, grp = sweep.unpack_hits(starts, packed, R)
    check(bool((rows[1:] >= rows[:-1]).all())
          and torch.equal(rows, flat.long().sort().values),
          "sweep_prep: the hits are not the sorted rows")
    check(torch.equal(grp.sort().values, torch.arange(n, device="cuda") // k),
          "sweep_prep: group ids")
    out = sweep.sweep_aggregate(starts, packed, table, groups, R)
    ref = sweep.sweep_aggregate_plain(starts, packed, table, groups, R)
    torch.cuda.synchronize()
    check(out.shape == (groups, d) and out.dtype == torch.float32,
          "sweep_aggregate shape/dtype")
    err = (out - ref).abs().max().item() if n else 0.0
    check(torch.allclose(out, ref, rtol=1e-5, atol=1e-5),
          "sweep_aggregate %s D=%d R=%d N=%d over %d rows: max err %g"
          % (table.dtype, d, R, n, n_rows, err))
    return err


def check_sweep(torch, sweep):
    """Kernel 4 against sweep_aggregate_plain and Kernel 5 against
    stream_sum_plain and a float64 column sum, with sweep_prep's hit list
    held to its invariants."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    n_rows, k = 20_011, 10  # not a multiple of either slab size
    worst4 = worst5 = 0.0
    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for d in (128, 100, 7):
            table = torch.randn((n_rows, d), generator=gen, device="cuda",
                                dtype=torch.float32).to(dtype)
            for R in (4096, 1024):
                # all rows; a narrow range (many duplicate rows, most slabs
                # empty); no hit at all
                for n, hi in ((15_360, n_rows), (4_000, 300), (0, n_rows)):
                    flat = torch.randint(0, hi, (n,), generator=gen,
                                         device="cuda", dtype=torch.int32)
                    worst4 = max(worst4, sweep_case(torch, sweep, table,
                                                    flat, k, R))
                    cases += 1
            for rows_ in (n_rows, 1, 0):
                t = table[:rows_].contiguous()
                out = sweep.stream_sum(t)
                ref = sweep.stream_sum_plain(t)
                exact = t.sum(0, dtype=torch.float64)
                limit = 1e-6 * t.abs().sum(0, dtype=torch.float64)
                torch.cuda.synchronize()
                check(out.shape == (1, d) and out.dtype == torch.float32,
                      "stream_sum shape/dtype")
                err = (out[0].double() - exact).abs()
                # n_rows f32 terms in another order than any reference:
                # held to 1e-6 of the column's sum of magnitudes (f64 sum)
                check(bool((err <= limit).all()) and torch.allclose(
                    out, ref, rtol=1e-4, atol=1e-6 * float(
                        t.abs().sum(0).max()) if rows_ else 0.0),
                    "stream_sum %s D=%d rows=%d: max err %g"
                    % (dtype, d, rows_, err.max().item() if d else 0.0))
                worst5 = max(worst5, float(err.max()) if rows_ else 0.0)
    # A tall table in slabs of 16 with few hits: a chunk of 32 hits spans
    # hundreds of slabs, so its window of 32 slab starts moves on many
    # times and the first slab's search takes three steps.  Rows of more
    # than 32 vectors (D = 256 f32, 300 bf16: 64 and 75 vectors): a lane
    # steps over the chunk's (hit, vector) pairs by whole rows' worth of
    # vectors, not by hits.
    tall = 200_003
    for dtype, d in ((torch.float32, 256), (torch.bfloat16, 300),
                     (torch.bfloat16, 100), (torch.float32, 7)):
        table = torch.randn((tall, d), generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype)
        for R, n, hi in ((16, 320, tall), (16, 4_000, tall),
                         (4096, 15_360, tall), (1024, 4_000, 300)):
            flat = torch.randint(0, hi, (n,), generator=gen, device="cuda",
                                 dtype=torch.int32)
            worst4 = max(worst4, sweep_case(torch, sweep, table, flat, k, R))
            cases += 1
        del table
    log("sweep_aggregate: %d cases within rtol=atol=1e-5 of "
        "sweep_aggregate_plain over bf16/f32, D in {128, 100, 7} at %d "
        "table rows with R in {4096, 1024}, duplicate rows, empty slabs, "
        "N=0; D in {256, 300, 100, 7} at %d rows with R in {16, 4096, 1024}, "
        "chunks of 32 hits over hundreds of slabs (max abs err %g); "
        "sweep_prep: starts[0]=0, starts[-1]=N, hits are the sorted rows; "
        "stream_sum: within 1e-6 of each column's sum of magnitudes of a "
        "float64 sum, rows in {%d, 1, 0} (max abs err %g)"
        % (cases, n_rows, tall, worst4, n_rows, worst5))


GAT_INPUTS = ("nbr", "wn", "ar", "el", "bn", "ba")
# gat_block against its plain version: both sum f32 products, in other
# orders (the kernel never forms nh, see csrc/gat.cu; its tensor-core
# products split every f32 operand into two TF32 numbers and sum three
# passes in f32), and the backward's sums across blocks use atomics.
# Errors are held relative to the largest reference value of each tensor:
# 2e-4 for f32, and 2^-7 for a bf16 d_nbr (one bf16 rounding of the f32 sum
# on either side).
GAT_TOL = 2e-4
GAT_TOL_BF16 = 2 ** -7


def gat_inputs(torch, gen, b, e, din, h, w, dtype, bias, drop, grad=True):
    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    t = dict(nbr=rand(b, e, din).to(dtype), wn=rand(h, din, w,
                                                    scale=din ** -0.5),
             ar=rand(h, w, scale=w ** -0.5), el=rand(h, b),
             bn=rand(h, w) if bias else None, ba=rand(h) if bias else None)
    if grad:
        for v in t.values():
            if v is not None:
                v.requires_grad_(True)
    t["drop"] = None
    if drop:
        keep = 0.7
        t["drop"] = (torch.rand((h, b, e), generator=gen, device="cuda")
                     < keep).float() / keep
    return t


def gat_compare(torch, gat, t, g):
    """(worst relative error, its name) of gat_block's output and of every
    input gradient against gat_block_plain on the same tensors."""
    args = [t[n] for n in GAT_INPUTS] + [t["drop"]]
    names = [n for n in GAT_INPUTS
             if t[n] is not None and t[n].requires_grad]
    leaves = [t[n] for n in names]
    out = gat.gat_block(*args)
    grads = torch.autograd.grad(out, leaves, g)
    ref = gat.gat_block_plain(*args)
    ref_grads = torch.autograd.grad(ref, leaves, g)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == torch.float32,
          "gat_block shape/dtype")
    worst, abs_err = (0.0, "out"), 0.0
    pairs = [("out", out, ref)] + [("d_" + n, a, r) for n, a, r
                                   in zip(names, grads, ref_grads)]
    for name, got, want in pairs:
        check(got.shape == want.shape and got.dtype == want.dtype,
              "gat_block %s shape/dtype" % name)
        check(bool(torch.isfinite(got).all()), "gat_block %s not finite"
              % name)
        if got.numel() == 0:
            continue
        err = (got.float() - want.float()).abs().max().item()
        rel = err / max(1.0, want.float().abs().max().item())
        tol = GAT_TOL_BF16 if got.dtype == torch.bfloat16 else GAT_TOL
        check(rel <= tol, "gat_block %s: max abs err %g, %g of the largest "
              "reference value (limit %g)" % (name, err, rel, tol))
        if rel / tol > worst[0]:
            worst = (rel / tol, name)
        if name == "out":
            abs_err = err
    return worst, abs_err


# the training path's first-layer call at its full size, and a deep
# reduction for d_wn (depth b = 20 011, K' = 37 padded to 40): the split
# TF32 products held where the depth is real; f32 rows, (bias, drop) given
GAT_DEEP_CASES = (((15_360, 10, 128, 8, 256), False, False),
                  ((20_011, 2, 36, 2, 40), True, True))


def check_gat(torch, gat):
    gen = torch.Generator(device="cuda").manual_seed(4)
    # the model's three calls at reduced b, then ragged and odd sizes
    shapes = [(777, 10, 128, 8, 256), (777, 15, 128, 8, 256),
              (777, 15, 256, 1, 32), (1, 1, 4, 3, 5), (777, 1, 100, 3, 5),
              (1, 15, 4, 1, 32), (33, 10, 100, 3, 5), (17, 4, 20, 9, 12),
              (0, 10, 128, 8, 256)]
    cases = [(shape, dtype, bias, drop) for shape in shapes
             for dtype in (torch.float32, torch.bfloat16)
             for bias, drop in ((False, False), (True, True))]
    cases += [(shape, torch.float32, bias, drop)
              for shape, bias, drop in GAT_DEEP_CASES]
    worst = (0.0, "")
    routes = {"tensor": 0, "fma": 0, "no launch": 0}
    wgmma_cases = 0
    for shape, dtype, bias, drop in cases:
        b, e, din, h, w = shape
        t = gat_inputs(torch, gen, b, e, din, h, w, dtype, bias, drop)
        g = torch.randn((h, b, w), generator=gen, device="cuda")
        before = {r: c.count for r, c in gat.ROUTE_LAUNCHES.items()}
        wgmma_before = gat.WGMMA_LAUNCHES.count
        try:
            (rel, name), _ = gat_compare(torch, gat, t, g)
        except SmokeFailure as err:
            raise SmokeFailure("%s at (b, e, Din, H, W)=%s %s bias=%s "
                               "drop=%s" % (err, shape, dtype, bias, drop))
        took = {r: c.count - before[r]
                for r, c in gat.ROUTE_LAUNCHES.items()}
        # forward and backward of one case take the same route, the one
        # the shape rule names; b = 0 launches nothing
        want = gat.product_route(w) if b else "no launch"
        check(took == {r: 2 * (r == want) for r in took},
              "gat_block at %s: route launches %s, the shape rule says %s"
              % (shape, took, want))
        routes[want] += 1
        # the forward's product ran on wgmma exactly where the depth rule
        # says so (K' = Din + 1 with a bias)
        on_wgmma = bool(b) and gat.forward_product_kernel(
            din + (1 if bias else 0), w) == "wgmma"
        check(gat.WGMMA_LAUNCHES.count - wgmma_before == int(on_wgmma),
              "gat_block at %s bias=%s: %d wgmma launches, the depth rule "
              "says %d" % (shape, bias, gat.WGMMA_LAUNCHES.count
                           - wgmma_before, on_wgmma))
        wgmma_cases += on_wgmma
        if rel > worst[0]:
            worst = (rel, "%s at %s %s" % (name, shape, dtype))
    check(routes["tensor"] > 0 and routes["fma"] > 0
          and 0 < wgmma_cases < routes["tensor"],
          "gat_block: a product route or kernel was never taken: %s, %d on "
          "wgmma" % (routes, wgmma_cases))
    log("gat_block: forward and every gradient (nbr, wn, ar, el, bn, ba) "
        "match gat_block_plain in %d cases: f32/bf16 nbr, bias and drop "
        "on/off, (b, e, Din, H, W) in %s, and f32 at %s; limits %g (f32) "
        "and 2^-7 (bf16 d_nbr) of each tensor's largest reference value; "
        "worst case %.3f of its limit (%s); product routes by case: %s; "
        "the forward's product on wgmma in %d of the tensor cases, on "
        "mma.sync in the rest"
        % (len(cases), shapes, [c[0] for c in GAT_DEEP_CASES], GAT_TOL,
           worst[0], worst[1], routes, wgmma_cases))


def measure_gat(torch, gat):
    """Time gat_block, forward and backward, and its plain version at the
    training path's largest call: the first layer's deepest hop,
    (b, e, Din, H, W) = (15 360, 10, 128, 8, 256), f32 rows, no bias and no
    dropout, gradients for wn, ar and el (the rows there are features: no
    d_nbr), as the training phase calls it."""
    k1, k2 = FANOUT
    b, e, din, h, w = MICRO_BATCH * k1, k2, FEAT_DIM, GAT_HEADS[0], HIDDEN
    gen = torch.Generator(device="cuda").manual_seed(5)
    t = gat_inputs(torch, gen, b, e, din, h, w, torch.float32, False, False)
    t["nbr"].requires_grad_(False)
    g = torch.randn((h, b, w), generator=gen, device="cuda")
    (rel, name), err = gat_compare(torch, gat, t, g)
    args = [t[n] for n in GAT_INPUTS] + [None]
    leaves = [t["wn"], t["ar"], t["el"]]
    out = gat.gat_block(*args)
    plain = gat.gat_block_plain(*args)

    def backward(o):
        return lambda: torch.autograd.grad(o, leaves, g, retain_graph=True)

    with torch.no_grad():
        ms = time_ms(lambda: gat.gat_block(*args), iters=20, hold=True)
        plain_ms = time_ms(lambda: gat.gat_block_plain(*args), iters=10,
                           warmup=2, hold=True)
        x2 = t["nbr"].reshape(b * e, din)
        proj_ms = time_ms(lambda: torch.einsum("nd,hdw->hnw", x2, t["wn"]),
                          iters=10, warmup=2, hold=True)
    bwd_ms = time_ms(backward(out), iters=20, hold=True)
    plain_bwd_ms = time_ms(backward(plain), iters=10, warmup=2, hold=True)
    # what the function needs: every input read once, every output written
    # once; the operations of the restructured block (csrc/gat.cu): the
    # prep and two K-long dots per neighbour row and head (logit, weighted
    # sum) on the CUDA cores, the [b, K] x [K, W] product per head on the
    # tensor cores (counted once, whatever passes the kernel makes)
    k = din
    io = 4 * (b * e * din + h * din * w + h * w + h * b)
    dots = 2 * h * k * w + 4 * h * b * e * k
    product = 2 * h * b * k * w
    bound_ms, by = bound(io + 4 * h * b * w, dots, product)
    bound_f32_ms, _ = bound(io + 4 * h * b * w, dots + product)
    # backward: the forward's inputs and g read, d_wn, d_ar, d_el written;
    # the forward's attention again with two more dots per row and head
    # (d_q, d_v), and two products (d_a, d_wn)
    bwd_io = io + 4 * (h * b * w + h * din * w + h * w + h * b)
    bwd_dots = dots + 4 * h * b * e * k
    bwd_bound_ms, bwd_by = bound(bwd_io, bwd_dots, 2 * product)
    bwd_bound_f32_ms, _ = bound(bwd_io, bwd_dots + 2 * product)
    check(ms >= bound_ms and bwd_ms >= bwd_bound_ms,
          "gat_block ran under its bound: %g < %g or %g < %g ms"
          % (ms, bound_ms, bwd_ms, bwd_bound_ms))
    literal_ops = 2 * b * e * din * h * w
    row = dict(
        name="gat_block", route="cuda",
        source="graph_learn_tpu_torch/csrc/gat.cu",
        replaces="examples/segment_softmax_probe.py:36",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=by, library_ms=None, bound_f32_ms=bound_f32_ms,
        bwd_ms=bwd_ms, plain_bwd_ms=plain_bwd_ms, bwd_bound_ms=bwd_bound_ms,
        bwd_bound_by=bwd_by, bwd_bound_f32_ms=bwd_bound_f32_ms,
        product_route=gat.product_route(w),
        forward_product_kernel=gat.forward_product_kernel(k, w))
    check(row["product_route"] == "tensor"
          and row["forward_product_kernel"] == "wgmma",
          "gat_block at the training path's first-layer shape: products on "
          "the %s route, the forward's on %s"
          % (row["product_route"], row["forward_product_kernel"]))
    log("gat_block at (b, e, Din, H, W)=%s f32, products on the %s route "
        "(the forward's on wgmma, the backward's on mma.sync): "
        "forward %.4f ms (plain %.4f, bound %.4f by %s, %.1f%% of it; the "
        "all-f32 operations bound of the FMA route %.4f), backward for wn, "
        "ar, el %.4f ms (plain %.4f, bound %.4f by %s, %.1f%% of it; all-f32 "
        "%.4f); max abs err of the output %g, worst tensor %s at %.3f of its "
        "limit (%g of its largest reference value)"
        % ((b, e, din, h, w), row["product_route"], ms, plain_ms, bound_ms,
           by, 100 * bound_ms / ms, bound_f32_ms, bwd_ms, plain_bwd_ms,
           bwd_bound_ms, bwd_by, 100 * bwd_bound_ms / bwd_ms,
           bwd_bound_f32_ms, err, name, rel, GAT_TOL))
    log("gat_block reference points: no single PyTorch call computes it "
        "(library_ms null); the cuBLAS f32 projection einsum nbr . wn alone "
        "takes %.4f ms; the block taken literally is %.4g operations (%.4f "
        "ms at the f32 peak), the kernel's restructured form %.4g forward"
        % (proj_ms, literal_ops, literal_ops / PEAK_F32_OPS_PER_S * 1e3,
           dots + product))
    row["parts"] = gat_parts(torch, gat, t, g)
    return row


def gat_parts(torch, gat, t, g):
    """Time each kernel of one gat_block forward and backward at the shape
    of ``t`` (stream held): the attention passes against the bytes they
    must move, the three products on both routes against their operations
    (each first held to the float64 product of its operands), and the
    small kernels.  Returns {part: ms}."""
    b, e, din = t["nbr"].shape
    h, k, w = t["wn"].shape
    lda = gat.padded_depth(k)
    parts = gat.GatParts(t["nbr"], t["wn"], t["ar"], t["el"], g)
    for part in parts.PARTS:  # every scratch tensor written once
        parts.run(part)
    torch.cuda.synchronize()
    # each product on each route against the float64 product of the same
    # operands (the scratch `a` of the attention pass, g, wn)
    a64, g64 = parts.t["a"][..., :k].double(), g.double()
    wn64 = t["wn"].detach().double()
    exact = {"product_out": ("out", torch.einsum("hbk,hkw->hbw", a64, wn64)),
             "product_da": ("da", torch.einsum("hbw,hkw->hbk", g64, wn64)),
             "product_dwn": ("d_wn", torch.einsum("hbk,hbw->hkw", a64, g64))}
    # "tensor" is the route the shape takes (product_out on wgmma here),
    # "mma" the same with every product on mma.sync
    routes = {part: ("tensor", "mma", "fma") if part == "product_out"
              else ("tensor", "fma") for part in exact}
    for part, (name, want) in exact.items():
        for route in routes[part]:
            parts.t[name].zero_()  # product_dwn adds into d_wn
            parts.run(part, route)
            got = parts.t[name][..., :want.shape[-1]].double()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            check(rel <= GAT_TOL, "gat_block %s on the %s route: %g of the "
                  "largest value off the float64 product (limit %g)"
                  % (part, route, rel, GAT_TOL))
            log("gat_block part %s on the %s route: %.3g of the largest "
                "value off the float64 product of the same operands "
                "(limit %g)" % (part, route, rel, GAT_TOL))
    del a64, g64, wn64
    nbr_bytes = t["nbr"].numel() * t["nbr"].element_size()
    a_bytes = 4 * h * b * lda
    traffic = {"attn_fwd": nbr_bytes + a_bytes + 4 * h * b,
               "attn_bwd": nbr_bytes + 2 * a_bytes + 8 * h * b,
               "prep": 4 * (h * k * w + h * w + h * k),
               "tail": 4 * (3 * h * k * w + 2 * h * w + h * k)}
    ops = 2 * h * b * k * w
    out = {}
    for part in parts.PARTS:
        if part.startswith("product"):
            for route in routes[part]:
                ms = time_ms(lambda: parts.run(part, route), iters=20,
                             hold=True)
                out["%s_%s" % (part, route)] = ms
                log("gat_block part %s on the %s route: %.4f ms, %.2f "
                    "TFLOP/s of its %.4g operations"
                    % (part, route, ms, ops / ms / 1e9, ops))
        else:
            ms = time_ms(lambda: parts.run(part), iters=20, hold=True)
            out[part] = ms
            least = traffic[part] / PEAK_BYTES_PER_S * 1e3
            log("gat_block part %s: %.4f ms, %.3f TB/s of the %.4g bytes it "
                "must move (%.4f ms at the peak rate, %.1f%%)"
                % (part, ms, traffic[part] / ms / 1e9, traffic[part], least,
                   100 * least / ms))
    return out


def spmm_work(torch, spmm, where, table, ids, deg):
    """The work one deepest-hop mean call puts on the card: one kernel,
    nothing else."""
    work, _ = check_one_launch(
        torch, "segment_spmm " + where, lambda: spmm.segment_spmm(
            table, ids, deg, "mean", torch.float32), "segment_spmm_kernel")
    log("segment_spmm %s: one call puts %s on the card" % (where, work))
    return {"work_per_call": work}


def measure_kernels(torch, gather, spmm):
    """Time each kernel, its plain version and one library call at the
    serving path's deepest-hop shapes.  The 51 MB table lies largely in the
    50 MB L2 across repeated calls on the same ids, and the bound counts
    device-memory bytes: so ``ms``, ``plain_ms`` and ``library_ms`` are
    cold (the L2 flushed before each call, the stream held while the host
    queues it) and
    ``warm_ms`` is the kernel's mean over back-to-back calls."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(3)
    table = torch.randn((N_NODES, FEAT_DIM), generator=gen, device="cuda",
                        dtype=torch.float32).to(torch.bfloat16)
    k1, k2 = FANOUT
    m = MICRO_BATCH * k1 * k2
    idx = torch.randint(0, N_NODES, (m,), generator=gen, device="cuda",
                        dtype=torch.int32)
    out = gather.gather_rows(table, idx)
    g_err = (out.float() - gather.gather_rows_plain(table, idx).float()
             ).abs().max().item()
    check(g_err == 0, "gather_rows at the serving shape: max err %g" % g_err)
    shapes = gather_shapes(torch, gather, table, gen, "at the 200k table",
                           rows=GATHER_PATH_ROWS + (m,), warm_rows=(m,),
                           given={m: idx}, yardsticks=GATHER_PATH_ROWS)
    rows = {
        "gather_rows": dict(
            name="gather_rows", route="cuda",
            source="graph_learn_tpu_torch/csrc/gather.cu",
            replaces="graph_learn_tpu/ops/pallas/gather.py:64",
            max_abs_err=g_err, ms=shapes[m]["ms"],
            plain_ms=time_cold_ms(lambda: gather.gather_rows_plain(table,
                                                                   idx)),
            bound_ms=shapes[m]["bound_ms"], bound_by="bytes",
            library_ms=time_cold_ms(lambda: torch.index_select(table, 0,
                                                               idx)),
            warm_ms=shapes[m]["warm_ms"], kernel_route=shapes[m]["route"]),
    }
    for rows_m in GATHER_PATH_ROWS:
        f = shapes[rows_m]
        rows["gather_rows"].update({
            "ms_%d" % rows_m: f["ms"], "bound_ms_%d" % rows_m: f["bound_ms"],
            "plain_ms_%d" % rows_m: f["plain_ms"],
            "library_ms_%d" % rows_m: f["library_ms"],
            "kernel_route_%d" % rows_m: f["route"]})
    ids = idx[:MICRO_BATCH * k1 * k2].reshape(MICRO_BATCH * k1, k2)
    deg = torch.full((ids.shape[0],), k2, dtype=torch.int32, device="cuda")
    out = spmm.segment_spmm(table, ids, deg, "mean", torch.float32)
    ref = spmm.segment_spmm_plain(table, ids, deg, "mean", torch.float32)
    s_err = (out - ref).abs().max().item()
    # f32 accumulation on both sides; only the order of the sums differs
    check(torch.allclose(out, ref, rtol=1e-5, atol=1e-5),
          "segment_spmm at the serving shape: max err %g" % s_err)
    nnz = int(deg.sum().item())
    s_bytes = (nnz * FEAT_DIM * table.element_size() + ids.numel() * 4
               + deg.numel() * 4 + ids.shape[0] * FEAT_DIM * 4)
    s_bound, s_by = bound(s_bytes, nnz * FEAT_DIM + ids.shape[0] * FEAT_DIM)
    rows["segment_spmm"] = dict(
        name="segment_spmm", route="cuda",
        source="graph_learn_tpu_torch/csrc/spmm.cu",
        replaces="graph_learn_tpu/ops/pallas/spmm.py:76",
        max_abs_err=s_err,
        ms=time_cold_ms(lambda: spmm.segment_spmm(table, ids, deg, "mean",
                                                  torch.float32)),
        plain_ms=time_cold_ms(lambda: spmm.segment_spmm_plain(
            table, ids, deg, "mean", torch.float32)),
        bound_ms=s_bound, bound_by=s_by,
        library_ms=time_cold_ms(lambda: F.embedding_bag(ids, table,
                                                        mode="mean")),
        warm_ms=time_ms(lambda: spmm.segment_spmm(
            table, ids, deg, "mean", torch.float32), hold=True))
    rows["segment_spmm"].update(spmm_work(
        torch, spmm, "at the serving shape", table, ids, deg))
    for r in rows.values():
        log("%s at the serving shape: %.4f ms cold L2, %.4f ms warm L2 "
            "(plain %.4f, library %.4f, both cold; bound %.4f by %s, %.1f%% "
            "of the cold call), max abs err %g (held: gather exact, spmm "
            "rtol=atol=1e-5)"
            % (r["name"], r["ms"], r["warm_ms"], r["plain_ms"],
               r["library_ms"], r["bound_ms"], r["bound_by"],
               100 * r["bound_ms"] / r["ms"], r["max_abs_err"]))
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the serving path at the benchmark's width
# ---------------------------------------------------------------------------


def two_hop_query(g, shuffle=False):
    k1, k2 = FANOUT
    src = g.V("item").batch(MICRO_BATCH)
    if shuffle:
        src = src.shuffle(traverse=True)
    return (src.alias("src")
            .outV("rel").sample(k1).by("random").alias("hop1")
            .outV("rel").sample(k2).by("random").alias("hop2").values())


def serving_path(torch, card, g, dec, gather, spmm):
    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch.core.values import DeferredRows
    from graph_learn_tpu_torch.nn.data import EgoGraph
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE

    k1, k2 = FANOUT
    t0 = time.perf_counter()
    q = two_hop_query(g)
    svc = gl.QueryService(g, device="cuda")
    qid = svc.install(q, micro_batch=MICRO_BATCH)
    table = q.device_tables()["nodes"]["item"].float_attrs
    model = EgoGraphSAGE([FEAT_DIM, HIDDEN, CLASSES], dec, agg_type="gcn",
                         device="cuda")
    log("query installed, tables (%d nodes, %d edges) on the card in %.1f s"
        % (N_NODES, N_NODES * AVG_DEGREE, time.perf_counter() - t0))

    def forward(ans):
        ego = EgoGraph.from_query_result(ans, "src", ["hop1", "hop2"],
                                         defer_last_table=table)
        with torch.no_grad():
            return model(ego)

    forward(svc.run(qid, np.arange(MICRO_BATCH)))  # warm-up, not counted
    torch.cuda.synchronize()

    rng = np.random.default_rng(1)
    requests = [[rng.integers(0, N_NODES, int(rng.integers(1, 2 * MICRO_BATCH)))
                 for _ in range(REQUESTS_PER_CLIENT)]
                for _ in range(N_CLIENTS)]
    answers = [[None] * REQUESTS_PER_CLIENT for _ in range(N_CLIENTS)]
    latency_ms = [[0.0] * REQUESTS_PER_CLIENT for _ in range(N_CLIENTS)]
    errors = []

    def client(c):
        try:
            for r, ids in enumerate(requests[c]):
                t0 = time.perf_counter()
                ans = svc.run(qid, ids)
                latency_ms[c][r] = (time.perf_counter() - t0) * 1e3
                answers[c][r] = (ids, ans, forward(ans))
        except Exception as e:  # reported below; fails the run
            errors.append(e)

    gather.LAUNCHES.reset()
    spmm.LAUNCHES.reset()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(N_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gather_rows": gather.LAUNCHES.count,
                "segment_spmm": spmm.LAUNCHES.count}
    check(not any(t.is_alive() for t in threads), "client threads hung")
    if errors:
        raise errors[0]
    lat = np.asarray(latency_ms).reshape(-1)
    seeds = sum(ids.size for reqs in requests for ids in reqs)
    log("served %d requests (%d seeds) from %d client threads in %.3f s, "
        "each answered and run through the forward; svc.run latency on the "
        "callers' clock: p50 %.3f ms, p99 %.3f ms, max %.3f ms; %.1f seeds/s "
        "over the clients' wall (card: %s)"
        % (lat.size, seeds, N_CLIENTS, wall, np.percentile(lat, 50),
           np.percentile(lat, 99), lat.max(), seeds / wall, card))
    log("launches during the serving phase: %s" % launches)
    check(launches["gather_rows"] > 0, "gather_rows was never launched")
    check(launches["segment_spmm"] > 0, "segment_spmm was never launched")

    # --- correctness of every answer ----------------------------------
    et = g.store.edge_table("rel")
    keys = np.unique(et.src * N_NODES + et.dst)
    out_deg = et.out_degrees
    default = gl.conf.default_neighbor_id

    def true_neighbours(parents, nbrs):
        p = np.repeat(parents.reshape(-1).astype(np.int64), nbrs.shape[-1])
        n = nbrs.reshape(-1).astype(np.int64)
        pos = np.clip(np.searchsorted(keys, p * N_NODES + n), 0,
                      keys.size - 1)
        hit = keys[pos] == p * N_NODES + n
        empty = out_deg[p] == 0
        return bool(np.all(np.where(empty, n == default, hit)))

    worst = 0.0
    for c in range(N_CLIENTS):
        for ids, ans, logits in answers[c]:
            n = ids.size
            src = ans["src"].ids.cpu().numpy()
            h1 = ans["hop1"].ids.cpu().numpy()
            h2 = ans["hop2"].ids.cpu().numpy()
            check(src.shape == (n,) and h1.shape == (n, k1)
                  and h2.shape == (n, k1, k2), "answer shapes")
            check(np.array_equal(src, ids), "src ids != requested ids")
            check(true_neighbours(src, h1), "hop1 holds a non-neighbour")
            check(true_neighbours(h1, h2), "hop2 holds a non-neighbour")
            plain = []
            for alias in ("src", "hop1", "hop2"):
                nodes = ans[alias]
                rows = table[nodes.ids.long()]
                check(isinstance(nodes.float_attrs, DeferredRows)
                      and torch.equal(nodes.float_attrs.materialize(), rows),
                      "%s features != table[ids]" % alias)
                plain.append(nodes.replace(float_attrs=rows))
            # the same forward on the plain versions: every hop's rows
            # gathered by plain indexing, the deepest reduced by the conv
            with torch.no_grad():
                ref = model(EgoGraph(src=plain[0], hops=plain[1:],
                                     nbr_nums=FANOUT))
            check(logits.shape == (n, CLASSES)
                  and bool(torch.isfinite(logits).all()), "logits")
            err = (logits - ref).abs().max().item()
            # f32 throughout; only the order of the deepest-hop sums differs
            check(torch.allclose(logits, ref, rtol=1e-4, atol=1e-4),
                  "logits differ from the plain forward: %g" % err)
            worst = max(worst, err)
    log("every sampled id is a neighbour, features equal table[ids], logits "
        "match the plain forward within rtol=atol=1e-4 (max abs err %g)"
        % worst)

    # --- forward rate on full micro-batches ---------------------------
    full = svc.run(qid, np.arange(MICRO_BATCH))
    t_fwd = time_ms(lambda: forward(full), iters=20, warmup=3)
    # a forward is a few dozen launches: 10 held calls stay well inside
    # the launch queue
    t_dev = time_ms(lambda: forward(full), iters=10, warmup=3, hold=True)
    edges = MICRO_BATCH * (k1 + k1 * k2)
    log("EgoGraphSAGE forward on a %d-seed answer, back to back: %.4f ms, "
        "%.4g edges/s; on the card alone %.4f ms, %.4g edges/s (card: %s)"
        % (MICRO_BATCH, t_fwd, edges / t_fwd * 1e3, t_dev,
           edges / t_dev * 1e3, card))
    where_the_time_goes(torch, card, svc, qid, forward)
    svc.close()
    return launches


def device_ms_by_kernel(prof):
    """{kernel name: device ms} summed over a torch.profiler run.  Ranges
    that user code annotates (``Optimizer.step#Adam.step``) also appear
    on the device's timeline, where their own time is the idle gaps
    between their kernels: they are left out."""
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if (dev_us > 0 and not getattr(ev, "is_user_annotation", False)
                and str(getattr(ev, "device_type", "")).endswith("CUDA")):
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + dev_us / 1e3
    return by_kernel


def where_the_time_goes(torch, card, svc, qid, forward):
    """One caller, full micro-batches: the host wall of a request and of the
    forward, then the device time by kernel from torch.profiler over the
    same work.  The profiler slows the host, so the device's busy share is
    taken against the wall measured without it."""
    from torch.profiler import ProfilerActivity, profile
    ids = np.arange(MICRO_BATCH)
    n_req = 20

    def host_ms(fn):
        """Median host wall of one call, each ended by a synchronize (the
        host clock is noisy on a shared machine)."""
        times, out = [], None
        for _ in range(n_req):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times)), out

    run_ms, ans = host_ms(lambda: svc.run(qid, ids))
    fwd_ms, _ = host_ms(lambda: forward(ans))
    wall_ms, _ = host_ms(lambda: forward(svc.run(qid, ids)))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms, _ = host_ms(lambda: forward(svc.run(qid, ids)))
    by_kernel = device_ms_by_kernel(prof)
    busy = sum(by_kernel.values()) / n_req
    log("one caller, %d requests of %d seeds, median per request on the "
        "host clock: svc.run %.3f ms, forward %.3f ms, both %.3f ms (%.3f ms "
        "under the profiler); device busy %.3f ms (%.1f%% of %.3f ms; card: "
        "%s)"
        % (n_req, MICRO_BATCH, run_ms, fwd_ms, wall_ms, profiled_ms, busy,
           100.0 * busy / wall_ms, wall_ms, card))
    if not by_kernel:
        log("torch.profiler recorded no device time: busy share not measured")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    for name, ms in top:
        log("  device %.4f ms per request: %s" % (ms / n_req, name[:90]))


# ---------------------------------------------------------------------------
# Phase 6: the training path at the benchmark's width
# ---------------------------------------------------------------------------

HOPS = ["hop1", "hop2"]
# One training step on the kernels against the same step on the plain
# versions (plain indexing for every hop's rows, the conv's own mean or
# gat_block_plain): f32 throughout, sums in other orders, and the GAT
# backward's atomicAdd.  The loss within 1e-4 relative; each gradient
# within 1e-3 of its largest reference value.
STEP_LOSS_RTOL, STEP_GRAD_TOL = 1e-4, 1e-3


def training_path(torch, card, g, dec, gather, spmm, gat):
    """Both model families through LocalTrainer.train; returns the launch
    counts of the two measured runs."""
    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch.nn import data as gdata
    from graph_learn_tpu_torch.nn.layers import ego as ego_layers
    from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGAT, EgoGraphSAGE
    from graph_learn_tpu_torch.nn.trainer import LocalTrainer
    from torch.profiler import ProfilerActivity, profile

    k1, k2 = FANOUT
    edges_per_step = MICRO_BATCH * (k1 + k1 * k2)
    q = two_hop_query(g, shuffle=True)
    table = q.device_tables()["nodes"]["item"].float_attrs
    dims = [FEAT_DIM, HIDDEN, CLASSES]
    # (depth, width) of the three gat_block calls of an EgoGAT step: layer 1
    # on both hops, layer 2 (no bias; the heads are averaged)
    gat_call_shapes = [(FEAT_DIM, HIDDEN), (FEAT_DIM, HIDDEN),
                       (HIDDEN, CLASSES)]
    counters = {"gather_rows": gather.LAUNCHES, "segment_spmm": spmm.LAUNCHES,
                "gat_block": gat.LAUNCHES_FWD,
                "gat_block_bwd": gat.LAUNCHES_BWD}

    def pre_aggregate(batch, tables):
        return gdata.pre_aggregate_hop(
            batch, "hop2", tables["nodes"]["item"].float_attrs, op="mean")

    def loss_of(model, batch):
        ego = gdata.EgoGraph.from_query_result(batch, "src", HOPS)
        return supervised_softmax_loss(model(ego, training=True),
                                       batch["src"].labels)

    def plain_batch(batch):
        """The same batch with every hop's rows taken by plain indexing."""
        return {a: v.replace(float_attrs=table[v.ids.long()])
                for a, v in batch.items()}

    def loss_and_grads(model, batch):
        loss = loss_of(model, batch)
        return loss, torch.autograd.grad(loss, list(model.parameters()))

    def one_step_against_plain(name, model, transform):
        # a batch from the Dataset: queued ahead on its side stream
        ds = gl.Dataset(q, window=2, transform=transform, device="cuda")
        batch = ds.next()
        loss, grads = loss_and_grads(model, batch)
        kernel_block = ego_layers.gat_block
        ego_layers.gat_block = gat.gat_block_plain
        try:
            ref_loss, ref_grads = loss_and_grads(model, plain_batch(batch))
        finally:
            ego_layers.gat_block = kernel_block
        torch.cuda.synchronize()
        lerr = abs(loss.item() - ref_loss.item())
        check(lerr <= STEP_LOSS_RTOL * abs(ref_loss.item()),
              "%s: loss %g on the kernels, %g on the plain versions"
              % (name, loss.item(), ref_loss.item()))
        worst = 0.0
        for (pname, _), got, want in zip(model.named_parameters(), grads,
                                         ref_grads):
            rel = ((got - want).abs().max().item()
                   / max(want.abs().max().item(), 1e-12))
            check(rel <= STEP_GRAD_TOL, "%s: gradient of %s off by %g of its "
                  "largest value" % (name, pname, rel))
            worst = max(worst, rel)
        log("%s: one step on the kernels against the plain versions: loss "
            "%.6f vs %.6f (limit %g relative), worst gradient error %.3g of "
            "the tensor's largest value (limit %g)"
            % (name, loss.item(), ref_loss.item(), STEP_LOSS_RTOL, worst,
               STEP_GRAD_TOL))

    def run(name, model, transform, epochs, steps, expect):
        losses = []

        def loss_fn(model, batch, generator, training):
            loss = loss_of(model, batch)
            losses.append(loss.detach())
            return loss

        one_step_against_plain(name, model, transform)
        opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
        tr = LocalTrainer(seed=0, device="cuda")

        def train(n_epochs, n_steps):
            t0 = time.perf_counter()
            _, hist = tr.train(q, model, loss_fn, opt, epochs=n_epochs,
                               steps_per_epoch=n_steps, verbose=False,
                               batch_transform=transform)
            torch.cuda.synchronize()
            return hist, time.perf_counter() - t0

        train(1, 3)  # warm-up, not counted
        before = [p.detach().clone() for p in model.parameters()]
        del losses[:]
        for c in (list(counters.values()) + list(gat.ROUTE_LAUNCHES.values())
                  + [gat.WGMMA_LAUNCHES]):
            c.reset()
        hist, wall = train(epochs, steps)
        launches = {k: c.count for k, c in counters.items()}
        routes = {r: c.count for r, c in gat.ROUTE_LAUNCHES.items()}
        wgmma_launches = gat.WGMMA_LAUNCHES.count
        n = epochs * steps
        check(len(losses) == n and len(hist) == epochs, "%s: %d losses, %d "
              "epochs" % (name, len(losses), len(hist)))
        check(bool(torch.isfinite(torch.stack(losses)).all())
              and all(np.isfinite(hist)), "%s: a loss is not finite" % name)
        check(all(not torch.equal(a, p.detach()) and
                  bool(torch.isfinite(p).all())
                  for a, p in zip(before, model.parameters())),
              "%s: a parameter did not move or is not finite" % name)
        want = {k: v * n for k, v in expect.items()}
        check(launches == want, "%s: launches %s, expected %s"
              % (name, launches, want))
        # every gat_block call of the training path, forward and backward,
        # has its products on the tensor cores
        check(routes == {"tensor": launches["gat_block"]
                         + launches["gat_block_bwd"], "fma": 0},
              "%s: product routes %s for launches %s"
              % (name, routes, launches))
        # and the two first-layer forwards of a GAT step (depth 128) have
        # theirs on wgmma; the second layer's depth (256) takes mma.sync
        want_wgmma = sum(gat.forward_product_kernel(d, w) == "wgmma"
                         for d, w in gat_call_shapes) * n
        check(wgmma_launches == (want_wgmma if launches["gat_block"] else 0),
              "%s: %d forwards on wgmma, expected %d"
              % (name, wgmma_launches, want_wgmma))
        step_ms = wall / n * 1e3
        # the device's share of a step: device time by kernel under the
        # profiler over the wall measured without it
        n_prof = 5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, prof_wall = train(1, n_prof)
        by_kernel = device_ms_by_kernel(prof)
        busy = sum(by_kernel.values()) / n_prof
        log("%s: %d steps of batch %d through LocalTrainer.train in %.3f s: "
            "%.3f ms per step on the host clock (%.3f ms under the "
            "profiler), %.4g edges/s; per-epoch mean loss %s; launches %s, "
            "gat_block product routes %s, %d forwards on wgmma; "
            "device busy %.3f ms per step (%.1f%% of the step; card: %s)"
            % (name, n, MICRO_BATCH, wall, step_ms, prof_wall / n_prof * 1e3,
               edges_per_step / step_ms * 1e3,
               ["%.4f" % x for x in hist], launches, routes, wgmma_launches,
               busy, 100.0 * busy / step_ms, card))
        if not by_kernel:
            log("torch.profiler recorded no device time: busy share not "
                "measured")
        for kname, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            log("  device %.4f ms per step: %s" % (ms / n_prof, kname[:90]))
        return launches

    sage = EgoGraphSAGE(dims, dec, agg_type="gcn", device="cuda")
    sage_launches = run(
        "EgoGraphSAGE %s gcn, deepest hop pre-aggregated" % dims, sage,
        pre_aggregate, SAGE_EPOCHS, SAGE_STEPS,
        {"gather_rows": 2, "segment_spmm": 1, "gat_block": 0,
         "gat_block_bwd": 0})
    gat_model = EgoGAT(dims, dec, num_heads=list(GAT_HEADS), device="cuda")
    gat_launches = run(
        "EgoGAT %s heads %s" % (dims, list(GAT_HEADS)), gat_model, None, 1,
        GAT_STEPS, {"gather_rows": 3, "segment_spmm": 0, "gat_block": 3,
                    "gat_block_bwd": 3})
    return sage_launches, gat_launches


# ---------------------------------------------------------------------------
# Phase 7: the sweep-aggregate harness and Kernels 4-5 at its full shape
# ---------------------------------------------------------------------------


def sweep_split(torch, sweep, starts, packed, table, groups, R, where):
    """Kernel 4's call in parts, from the profiler's events of the same
    calls: the work one call puts on the card (the kernel and at most one
    memset), the zero fill's device time (the memset) and the kernel's."""
    work, ms = check_one_launch(
        torch, "sweep_aggregate " + where, lambda: sweep.sweep_aggregate(
            starts, packed, table, groups, R), "sweep_aggregate_kernel",
        allow_memset=True)
    check("memset" in ms, "sweep_aggregate %s: the profiler recorded no "
          "memset of the output in %s" % (where, work))
    return {"fill_ms": ms["memset"], "kernel_ms": ms["kernel"],
            "work_per_call": work}


def sweep_rows(torch, card, sweep, spmm):
    """Run the harness at the frontier shape (2 457 600 x 128 f32, 153 600
    hits in groups of 10), then time Kernels 4 and 5, their plain versions
    and the one library call on the same shape; returns the two rows."""
    from graph_learn_tpu_torch.examples import sweep_aggregate as harness

    sweep.LAUNCHES_SWEEP.reset()
    sweep.LAUNCHES_STREAM.reset()
    r = harness.run(small=False, steps=30, slab=4096, device="cuda")
    harness_launches = {"sweep_aggregate": sweep.LAUNCHES_SWEEP.count,
                        "stream_sum": sweep.LAUNCHES_STREAM.count}
    check(all(v > 0 for v in harness_launches.values()),
          "the harness did not launch both kernels: %s" % harness_launches)
    log("sweep harness at %d x %d f32, N=%d, k=%d, R=%d (%s): bar %.4f ms "
        "(plain %.4f), prep %.4f, stream %.4f, sweep %.4f, total prep + "
        "sweep %.4f ms against the bar's %.4f; sweep / k within 1e-5 of the "
        "plain mean (max abs err %g), stream sum within 1e-6 of each "
        "column's sum of magnitudes (max abs err %g); card: %s"
        % (r["n_rows"], harness.D, r["n_hits"], r["k"], r["slab"],
           r["timer"], r["bar_ms"], r["bar_plain_ms"], r["prep_ms"],
           r["stream_ms"], r["sweep_ms"], r["total_ms"], r["bar_ms"],
           r["sweep_max_abs_err"], r["stream_max_abs_err"], card))

    n_rows, n, k, d, R = r["n_rows"], r["n_hits"], r["k"], harness.D, 4096
    groups = n // k
    gen = torch.Generator(device="cuda").manual_seed(7)
    table = torch.randn((n_rows, d), generator=gen, device="cuda")
    flat = torch.randint(0, n_rows, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    starts, packed = sweep.sweep_prep(flat, k, n_rows, R)
    out = sweep.sweep_aggregate(starts, packed, table, groups, R)
    ref = sweep.sweep_aggregate_plain(starts, packed, table, groups, R)
    err4 = (out - ref).abs().max().item()
    check(torch.allclose(out, ref, rtol=1e-5, atol=1e-5),
          "sweep_aggregate at the harness shape: max err %g" % err4)
    # what these inputs need: each distinct hit row once, the hit list and
    # the slab starts, [G, D] f32 written once; one add per hit element
    distinct = int(torch.unique(flat).numel())
    bytes4 = (distinct * d * 4 + n * 4 + starts.numel() * 4 + groups * d * 4)
    b4, by4 = bound(bytes4, n * d)
    row4 = dict(
        name="sweep_aggregate", route="cuda",
        source="graph_learn_tpu_torch/csrc/sweep.cu",
        replaces="examples/sweep_aggregate.py:39", max_abs_err=err4,
        ms=time_ms(lambda: sweep.sweep_aggregate(starts, packed, table,
                                                 groups, R), hold=True),
        plain_ms=time_ms(lambda: sweep.sweep_aggregate_plain(
            starts, packed, table, groups, R), iters=20, hold=True),
        bound_ms=b4, bound_by=by4,
        # no single PyTorch call sums rows picked by one index into groups
        # picked by another: index_select + index_add_ are two calls, and
        # embedding_bag on the sorted ids gives per-bag sums of consecutive
        # ids, not per-group sums
        library_ms=None, harness_ms=r["sweep_ms"], prep_ms=r["prep_ms"],
        harness_launches=harness_launches["sweep_aggregate"])
    row4.update(sweep_split(torch, sweep, starts, packed, table, groups, R,
                            "at the harness shape"))
    log("sweep_aggregate at the harness shape, the call in parts: zero fill "
        "%.4f ms, kernel %.4f ms, the call %.4f ms; one call puts %s on the "
        "card" % (row4["fill_ms"], row4["kernel_ms"], row4["ms"],
                  row4["work_per_call"]))
    # Kernel 2's bar in the harness against its bound: the hit rows read
    # once, the ids and degrees, [G, D] f32 written once
    bar_bound, _ = bound(n * d * 4 + n * 4 + groups * 4 + groups * d * 4,
                         n * d + groups * d)
    bar = {"bar_ms": r["bar_ms"], "bar_plain_ms": r["bar_plain_ms"],
           "bar_bound_ms": bar_bound}
    bar.update({key + "_bar": v for key, v in spmm_work(
        torch, spmm, "as the harness bar", table, flat.reshape(groups, k),
        torch.full((groups,), k, dtype=torch.int32, device="cuda")).items()})
    log("segment_spmm as the harness bar (%d hits into %d x %d f32): %.4f "
        "ms, bound %.4f by bytes (%.1f%% of it)"
        % (n, n_rows, d, r["bar_ms"], bar_bound, 100 * bar_bound / r["bar_ms"]))

    s_out = sweep.stream_sum(table)
    exact = table.sum(0, dtype=torch.float64)
    s_err = (s_out[0].double() - exact).abs()
    limit = 1e-6 * table.abs().sum(0, dtype=torch.float64)
    check(bool((s_err <= limit).all()), "stream_sum at the harness shape: "
          "max err %g" % s_err.max().item())
    b5, by5 = bound(n_rows * d * 4 + d * 4, n_rows * d)
    row5 = dict(
        name="stream_sum", route="cuda",
        source="graph_learn_tpu_torch/csrc/sweep.cu",
        replaces="examples/sweep_aggregate.py:96",
        max_abs_err=s_err.max().item(),
        ms=time_ms(lambda: sweep.stream_sum(table), iters=20, hold=True),
        plain_ms=time_ms(lambda: sweep.stream_sum_plain(table), iters=20,
                         hold=True),
        bound_ms=b5, bound_by=by5,
        library_ms=time_ms(lambda: table.sum(0), iters=20, hold=True),
        harness_ms=r["stream_ms"], launches=harness_launches["stream_sum"])
    for row in (row4, row5):
        log("%s at the harness shape: %.4f ms (in the harness %.4f; plain "
            "%.4f, library %s, bound %.4f by %s), max abs err %g"
            % (row["name"], row["ms"], row["harness_ms"], row["plain_ms"],
               "none" if row["library_ms"] is None
               else "%.4f" % row["library_ms"], row["bound_ms"],
               row["bound_by"], row["max_abs_err"]))
    return row4, row5, bar


# ---------------------------------------------------------------------------
# Phase 8: the 62M-edge frontier path (examples/scale_demo.py)
# ---------------------------------------------------------------------------

SCALE_STEPS, SCALE_WARMUP = 30, 3
# the first-step loss of the sorted route against the unsorted route's:
# the same ids and weights, only the order of the deepest hop's f32 sums
# differs (and changes from run to run under the sweep kernel's atomics)
SORTED_LOSS_RTOL = 1e-5


def scale_path(torch, card, gl, gather, spmm, sweep):
    """examples.scale_demo.run at the published sizes, unsorted and sorted
    route; returns ({kernel: launches} of each run, extra row fields)."""
    import torch.nn.functional as F
    from graph_learn_tpu_torch.examples import scale_demo
    from graph_learn_tpu_torch.nn.data import PreAggregatedRows
    from torch.profiler import ProfilerActivity, profile

    size = scale_demo.PUBLISHED
    n, d = size["n_nodes"], size["feat_dim"]
    b, (k1, k2) = size["batch"], size["fanout"]
    counters = {"gather_rows": gather.LAUNCHES, "segment_spmm": spmm.LAUNCHES,
                "sweep_aggregate": sweep.LAUNCHES_SWEEP}
    per_run = 1 + SCALE_WARMUP + SCALE_STEPS  # first batch, warm-up, steps

    def run(sorted_on, graph):
        gl.conf.sorted_gather = sorted_on
        for c in counters.values():
            c.reset()
        try:
            r = scale_demo.run(steps=SCALE_STEPS, warmup=SCALE_WARMUP,
                               device="cuda", graph=graph, **size)
        finally:
            gl.conf.sorted_gather = False
        launches = {k: c.count for k, c in counters.items()}
        deep = "sweep_aggregate" if sorted_on else "segment_spmm"
        want = {"gather_rows": 2 * per_run, "segment_spmm": 0,
                "sweep_aggregate": 0, deep: per_run}
        check(launches == want, "62M path (sorted_gather=%s): launches %s, "
              "expected %s" % (sorted_on, launches, want))
        losses = np.asarray(r["losses"])
        check(losses.shape == (SCALE_WARMUP + SCALE_STEPS,)
              and bool(np.isfinite(losses).all()),
              "62M path: a loss is not finite")
        log("62M path, sorted_gather=%s: %d steps of batch %d, fanout %s on "
            "%d nodes / %d edges / %d bf16 features: %.3f ms per step on the "
            "host clock, %.4g edges/s; loss %.4f -> %.4f; launches per step "
            "%s (card: %s)"
            % (sorted_on, SCALE_STEPS, b, [k1, k2], n, size["n_edges"], d,
               r["step_ms"], r["edges_per_s"], losses[0], losses[-1],
               {k: v // per_run for k, v in launches.items()}, card))
        return r, launches

    # unsorted, sorted, sorted, unsorted: the two routes are compared on the
    # host clock, which drifts, so each is run on both sides of the other
    r1, launches1 = run(False, None)
    log("62M store: host draw %.1f s, CSR build and tables onto the card "
        "%.1f s, %.3f GB of tables on the card, %.3f GB allocated by the "
        "process at the peak of the run (torch.cuda.max_memory_allocated)"
        % (r1["host_build_s"], r1["tables_s"], r1["tables_bytes"] / 1e9,
           r1["device_bytes_peak"] / 1e9))
    r2, launches2 = run(True, r1["graph"])
    r3, _ = run(True, r1["graph"])
    r4, _ = run(False, r1["graph"])
    l1 = r1["losses"][0]
    for r in (r2, r3, r4):
        check(abs(l1 - r["losses"][0]) <= SORTED_LOSS_RTOL * abs(l1),
              "62M path: first-step loss %g, then %g" % (l1, r["losses"][0]))
    step = {False: (r1["step_ms"], r4["step_ms"]),
            True: (r2["step_ms"], r3["step_ms"])}
    q, model = r1["query"], r1["model"]
    tables = q.device_tables("cuda")
    table = tables["nodes"]["item"].float_attrs
    et = tables["edges"]["rel"]
    check(table.shape == (n, d) and table.dtype == torch.bfloat16
          and et.out.num_edges == size["n_edges"] and et.inc is None
          and et.out.cum_in_degrees is None,
          "62M store is not the minimal profile at the published sizes")

    # one step on the kernels against the same step on the plain versions
    gen = torch.Generator(device="cuda").manual_seed(11)
    seeds = torch.randint(0, n, (b,), generator=gen, device="cuda",
                          dtype=torch.int32)
    batch = scale_demo.sample_batch(q, tables, seeds, gen)
    plain = {a: v.replace(float_attrs=table[v.ids.long()])
             for a, v in batch.items()}
    plain["hop2"] = batch["hop2"].replace(float_attrs=PreAggregatedRows(
        table[batch["hop2"].ids.long()].float().reshape(-1, k2, d).mean(1),
        "mean"))
    params = list(model.parameters())
    loss = scale_demo.loss_of(model, batch)
    grads = torch.autograd.grad(loss, params)
    ref_loss = scale_demo.loss_of(model, plain)
    ref_grads = torch.autograd.grad(ref_loss, params)
    torch.cuda.synchronize()
    check(abs(loss.item() - ref_loss.item())
          <= STEP_LOSS_RTOL * abs(ref_loss.item()),
          "62M path: loss %g on the kernels, %g on the plain versions"
          % (loss.item(), ref_loss.item()))
    worst = max((g - w).abs().max().item() / max(w.abs().max().item(), 1e-12)
                for g, w in zip(grads, ref_grads))
    check(worst <= STEP_GRAD_TOL, "62M path: a gradient is off by %g of its "
          "largest value" % worst)
    log("62M path: one step on the kernels against the plain versions: loss "
        "%.6f vs %.6f (limit %g relative), worst gradient error %.3g of the "
        "tensor's largest value (limit %g)"
        % (loss.item(), ref_loss.item(), STEP_LOSS_RTOL, worst,
           STEP_GRAD_TOL))

    # the device's share of a step, both routes
    opt = torch.optim.Adam(model.parameters(), lr=scale_demo.LEARNING_RATE)
    n_prof = 5
    busy = {}
    for sorted_on in (False, True):
        gl.conf.sorted_gather = sorted_on
        try:
            scale_demo.train_steps(q, tables, model, opt, 2, n, gen)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                scale_demo.train_steps(q, tables, model, opt, n_prof, n, gen)
                torch.cuda.synchronize()
        finally:
            gl.conf.sorted_gather = False
        by_kernel = device_ms_by_kernel(prof)
        busy[sorted_on] = sum(by_kernel.values()) / n_prof
        log("62M path, sorted_gather=%s: device busy %.3f ms per step under "
            "torch.profiler (%d steps)%s"
            % (sorted_on, busy[sorted_on], n_prof,
               "" if by_kernel else ": no device time recorded, not "
               "measured"))
        for kname, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
            log("  device %.4f ms per step: %s" % (ms / n_prof, kname[:90]))

    log("62M path: first-step loss %.7f unsorted, %.7f sorted (limit %g "
        "relative); step on the host clock, runs in the order unsorted, "
        "sorted, sorted, unsorted: %.3f, %.3f, %.3f, %.3f ms; device busy "
        "%.3f ms unsorted (%.1f%% of the mean step), %.3f ms sorted (%.1f%%); "
        "card: %s"
        % (l1, r2["losses"][0], SORTED_LOSS_RTOL, r1["step_ms"],
           r2["step_ms"], r3["step_ms"], r4["step_ms"], busy[False],
           100.0 * busy[False] / np.mean(step[False]), busy[True],
           100.0 * busy[True] / np.mean(step[True]), card))

    # Kernels 1, 2 and 4 at this table: 2.45M rows of 200 bytes, ten times
    # the L2.  Warm: 50 calls on the same ids, whose 153 600 rows (about 39
    # MB counted in 32-byte sectors) the L2 largely keeps from call to
    # call; cold: the L2 flushed before each call (utils/timing.py
    # time_cold_ms), as a training step finds it with new ids every time
    m = b * k1 * k2
    idx = torch.randint(0, n, (m,), generator=gen, device="cuda",
                        dtype=torch.int32)
    ids = idx.reshape(b * k1, k2)
    deg = torch.full((ids.shape[0],), k2, dtype=torch.int32, device="cuda")
    es = table.element_size()

    def warm_cold(fn):
        return {"ms_62m": time_ms(fn, hold=True),
                "cold_ms_62m": time_cold_ms(fn)}

    shapes = gather_shapes(torch, gather, table, gen, "at the 62M table",
                           rows=GATHER_PATH_ROWS + (m,), warm_rows=(m,),
                           given={m: idx}, yardsticks=GATHER_PATH_ROWS)
    extra = {"gather_rows": dict(
        ms_62m=shapes[m]["warm_ms"], cold_ms_62m=shapes[m]["ms"],
        plain_ms_62m=time_ms(lambda: gather.gather_rows_plain(table, idx),
                             iters=20, hold=True),
        library_ms_62m=time_ms(lambda: torch.index_select(table, 0, idx),
                               hold=True),
        bound_ms_62m=shapes[m]["bound_ms"],
        kernel_route_62m=shapes[m]["route"])}
    for rows_m in GATHER_PATH_ROWS:
        f = shapes[rows_m]
        extra["gather_rows"].update({
            "cold_ms_62m_%d" % rows_m: f["ms"],
            "bound_ms_62m_%d" % rows_m: f["bound_ms"],
            "plain_cold_ms_62m_%d" % rows_m: f["plain_ms"],
            "library_cold_ms_62m_%d" % rows_m: f["library_ms"],
            "kernel_route_62m_%d" % rows_m: f["route"]})
    out = spmm.segment_spmm(table, ids, deg, "mean", torch.float32)
    ref = spmm.segment_spmm_plain(table, ids, deg, "mean", torch.float32)
    check(torch.allclose(out, ref, rtol=1e-5, atol=1e-5),
          "segment_spmm at the 62M table: max err %g"
          % (out - ref).abs().max().item())
    s_bound, _ = bound(m * d * es + m * 4 + deg.numel() * 4
                       + ids.shape[0] * d * 4, m * d + ids.shape[0] * d)
    extra["segment_spmm"] = dict(
        warm_cold(lambda: spmm.segment_spmm(table, ids, deg, "mean",
                                            torch.float32)),
        plain_ms_62m=time_ms(lambda: spmm.segment_spmm_plain(
            table, ids, deg, "mean", torch.float32), iters=20, hold=True),
        library_ms_62m=time_ms(lambda: F.embedding_bag(
            ids, table, mode="mean"), hold=True),
        bound_ms_62m=s_bound)
    extra["segment_spmm"].update({
        k + "_62m": v for k, v in spmm_work(
            torch, spmm, "at the 62M table", table, ids, deg).items()})
    starts, packed = sweep.sweep_prep(idx, k2, n)
    out4 = sweep.sweep_aggregate(starts, packed, table, ids.shape[0]) / k2
    check(torch.allclose(out4, ref, rtol=1e-5, atol=1e-5),
          "sweep_aggregate / k at the 62M table: max err %g"
          % (out4 - ref).abs().max().item())
    w_bound, _ = bound(int(torch.unique(idx).numel()) * d * es + m * 4
                       + starts.numel() * 4 + ids.shape[0] * d * 4, m * d)
    extra["sweep_aggregate"] = dict(
        warm_cold(lambda: sweep.sweep_aggregate(starts, packed, table,
                                                ids.shape[0])),
        prep_ms_62m=time_ms(lambda: sweep.sweep_prep(idx, k2, n),
                            iters=20, hold=True),
        plain_ms_62m=time_ms(lambda: sweep.sweep_aggregate_plain(
            starts, packed, table, ids.shape[0], 4096), iters=20, hold=True),
        library_ms_62m=None, bound_ms_62m=w_bound)
    extra["sweep_aggregate"].update({
        k + "_62m": v for k, v in sweep_split(
            torch, sweep, starts, packed, table, ids.shape[0], 4096,
            "at the 62M table").items()})
    for name, f in extra.items():
        log("%s at the 62M table (%d x %d bf16, %d random rows): %.4f ms "
            "warm, %.4f ms cold (plain %.4f, library %s, bound %.4f by "
            "bytes)%s"
            % (name, n, d, m, f["ms_62m"], f["cold_ms_62m"],
               f["plain_ms_62m"], "none" if f["library_ms_62m"] is None
               else "%.4f" % f["library_ms_62m"], f["bound_ms_62m"],
               "; the call in parts: zero fill %.4f ms, kernel %.4f ms; "
               "sweep_prep %.4f ms" % (f["fill_ms_62m"], f["kernel_ms_62m"],
                                       f["prep_ms_62m"])
               if "prep_ms_62m" in f else ""))
    return launches1, launches2, extra


# ---------------------------------------------------------------------------
# Phase 9: the samplers that read the full store, through QueryService
# ---------------------------------------------------------------------------

FULL_CAP, STRATEGY_K = 32, 6


def full_store_queries(torch, g, spmm):
    """A "full" query answered by QueryService, its SparseNodes reduced by
    Kernel 2 on ragged degrees; an edge_weight and a topk query checked for
    true neighbours (topk: the heaviest edges first)."""
    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch.core.values import SparseNodes

    et = g.store.edge_table("rel")
    out_deg = et.out_degrees
    rng = np.random.default_rng(2)
    raw = rng.integers(0, N_NODES, 1500)
    svc = gl.QueryService(g, device="cuda")
    try:
        def ask(strategy, k):
            q = (g.V("item").batch(MICRO_BATCH).alias("src").outV("rel")
                 .sample(k).by(strategy).alias("nbrs").values())
            return svc.run(svc.install(q, micro_batch=MICRO_BATCH), raw)

        spmm.LAUNCHES.reset()
        ans = ask("full", FULL_CAP)
        nb = ans["nbrs"]
        check(isinstance(nb, SparseNodes) and nb.ids.shape == (raw.size,
                                                               FULL_CAP),
              "full query: not SparseNodes [n, cap]")
        check(np.array_equal(nb.degrees.cpu().numpy(),
                             np.minimum(out_deg[raw], FULL_CAP)),
              "full query: degrees are not the out-degrees clipped to cap")
        table = nb.float_attrs.table
        worst = 0.0
        for op in ("mean", "max"):
            got = nb.embedding_agg(op)
            ref = spmm.segment_spmm_plain(table, nb.ids, nb.degrees, op,
                                          table.dtype)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            # bf16 out: the order of the f32 sums may flip one bf16 rounding
            check(torch.allclose(got.float(), ref.float(), rtol=2 ** -7,
                                 atol=1e-5),
                  "SparseNodes.embedding_agg(%s): max err %g" % (op, err))
            worst = max(worst, err)
        launches = spmm.LAUNCHES.count
        check(launches == 2, "embedding_agg on ragged rows launched "
              "segment_spmm %d times, expected 2" % launches)
        # every listed neighbour is an out-edge of its seed, in adjacency
        # order (heaviest first), and the list is the whole row up to cap
        src64, dst64 = et.src, et.dst
        order = np.lexsort((-et.weights.astype(np.float64), src64))
        row_start = np.concatenate([[0], np.cumsum(out_deg)])
        ids = nb.ids.cpu().numpy()
        for i in rng.integers(0, raw.size, 200):
            lo = row_start[raw[i]]
            want = dst64[order[lo:lo + min(out_deg[raw[i]], FULL_CAP)]]
            check(np.array_equal(ids[i, :want.size], want),
                  "full query: row %d is not the seed's adjacency" % i)
        log("full query through QueryService: %d seeds, cap %d, degrees "
            "%d..%d (ragged), rows equal the weight-ordered adjacency; "
            "SparseNodes.embedding_agg mean/max on segment_spmm (%d "
            "launches) within rtol=2^-7, atol=1e-5 of the plain version "
            "(max abs err %g)"
            % (raw.size, FULL_CAP, nb.degrees.min().item(),
               nb.degrees.max().item(), launches, worst))

        keys = np.unique(src64 * N_NODES + dst64)
        for strategy in ("edge_weight", "topk"):
            hop = ask(strategy, STRATEGY_K)["nbrs"].ids.cpu().numpy()
            check(hop.shape == (raw.size, STRATEGY_K), strategy + ": shape")
            pair = np.repeat(raw, STRATEGY_K) * N_NODES + hop.reshape(-1)
            pos = np.clip(np.searchsorted(keys, pair), 0, keys.size - 1)
            empty = np.repeat(out_deg[raw] == 0, STRATEGY_K)
            check(bool(np.all(np.where(
                empty, hop.reshape(-1) == gl.conf.default_neighbor_id,
                keys[pos] == pair))), strategy + ": a non-neighbour")
            if strategy == "topk":
                for i in rng.integers(0, raw.size, 200):
                    lo, dg = row_start[raw[i]], out_deg[raw[i]]
                    if dg:
                        want = dst64[order[lo + np.arange(STRATEGY_K) % dg]]
                        check(np.array_equal(hop[i], want), "topk: row %d "
                              "is not the heaviest edges first" % i)
        log("edge_weight and topk queries through QueryService: every id a "
            "true neighbour (default fill on zero-degree seeds), topk rows "
            "the heaviest edges first with circular padding")
    finally:
        svc.close()
    return launches


FILTER_K = 15


def filtered_queries(torch, g):
    """``.outV("rel").sample(15).by(s).filter("src")`` through QueryService
    for random, topk, edge_weight and full, on every node that links to
    itself and 1 000 others: every id a true neighbour, and no hop-1 id
    equal to its seed in a row that lists the seed once beside another
    neighbour; without the filter the seeds do come back as their own
    neighbours."""
    import graph_learn_tpu_torch as gl

    et = g.store.edge_table("rel")
    src, dst = et.src, et.dst
    out_deg = et.out_degrees
    order = np.argsort(src, kind="stable")
    row_start = np.concatenate([[0], np.cumsum(out_deg)])
    loops = np.unique(src[src == dst])
    raw = np.concatenate([loops, np.random.default_rng(3).integers(
        0, N_NODES, 1000)])
    svc = gl.QueryService(g, device="cuda")
    hits = {}
    try:
        for strategy in ("random", "topk", "edge_weight", "full"):
            for filtered in (False, True):
                hop = (g.V("item").batch(MICRO_BATCH).alias("src")
                       .outV("rel").sample(FILTER_K).by(strategy))
                if filtered:
                    hop = hop.filter("src")
                q = hop.alias("nbrs").values()
                ans = svc.run(svc.install(q, micro_batch=MICRO_BATCH),
                              raw)["nbrs"]
                ids = ans.ids.cpu().numpy()
                deg = (ans.degrees.cpu().numpy() if strategy == "full"
                       else None)
                n_hits = 0
                for i, s in enumerate(raw):
                    row = dst[order[row_start[s]:row_start[s + 1]]]
                    got = ids[i, :deg[i]] if deg is not None else ids[i]
                    if row.size == 0:
                        check(bool(np.all(got == gl.conf.default_neighbor_id)),
                              "%s: a zero-degree seed got neighbours"
                              % strategy)
                        continue
                    check(bool(np.isin(got, row).all()),
                          "%s (filtered=%s): a non-neighbour of seed %d"
                          % (strategy, filtered, s))
                    n_hits += int((got == s).sum())
                    if filtered and (row == s).sum() == 1 and row.size > 1:
                        check(s not in got, "%s: seed %d sampled as its own "
                              "neighbour through .filter('src')"
                              % (strategy, s))
                hits[strategy, filtered] = n_hits
            check(hits[strategy, True] < hits[strategy, False],
                  "%s: the seeds came back %d times without the filter, %d "
                  "with it" % (strategy, hits[strategy, False],
                               hits[strategy, True]))
    finally:
        svc.close()
    log("filtered queries through QueryService, .sample(%d).by(s)"
        ".filter('src') on %d seeds (%d of them linked to themselves): "
        "every id a true neighbour, no seed its own neighbour where its row "
        "has another; the seeds came back as their own neighbours %s times "
        "without the filter, %s with it"
        % (FILTER_K, raw.size, loops.size,
           {s: hits[s, False] for s in ("random", "topk", "edge_weight",
                                        "full")},
           {s: hits[s, True] for s in ("random", "topk", "edge_weight",
                                       "full")}))


# ---------------------------------------------------------------------------
# Phase 11: the port bench (graph_learn_tpu_torch/bench.py), eager and in
# one CUDA graph
# ---------------------------------------------------------------------------

BENCH_KERNELS = ("gather_rows", "segment_spmm", "sweep_aggregate")


def bench_work(torch, fn, steps, calls, tries=3):
    """Kernels per step and device ms per step of the work ``calls`` calls
    of ``fn`` (``steps`` steps each) put on the card, from torch.profiler:
    under a replay each kernel of the graph is an event of its own.  A
    window that lost records (a kernel count that is no whole number a
    step) is profiled again, up to ``tries`` times."""
    for _ in range(tries):
        work, ms = device_work_per_call(torch, fn, calls=calls)
        per_step = {k: sum(c for n, c in work.items() if k in n) / steps
                    for k in BENCH_KERNELS}
        if all(v == int(v) for v in per_step.values()):
            by_name = {n: c * ms[n] / steps for n, c in work.items()}
            return per_step, sum(by_name.values()), by_name
        log("torch.profiler recorded %s kernels per step; profiling again"
            % per_step)
    check(False, "torch.profiler lost records in %d windows: %s kernels per "
          "step" % (tries, per_step))


def bench_path(torch, card, cfg, graph, gather, spmm, sweep, name,
               sorted_route=False):
    """``bench.run_bench(cfg)`` eager, then in a CUDA graph, from the same
    model seed, Adam state and generator seed: every step's loss bit for
    bit the same, and the same parameters after; two replays draw other
    seeds and give other losses; the profiler's kernels per replayed step
    are 2 gather_rows and 1 segment_spmm; every loss finite and every
    parameter moved.  With ``sorted_route`` a run under conf.sorted_gather
    is captured too (2 gather_rows and 1 sweep_aggregate a step).  Returns
    (row fields for the kernels line, the graph)."""
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE

    counters = {"gather_rows": gather.LAUNCHES, "segment_spmm": spmm.LAUNCHES,
                "sweep_aggregate": sweep.LAUNCHES_SWEEP}
    K, (k1, k2), b = cfg["scan_steps"], cfg["fanout"], cfg["batch"]
    for c in counters.values():
        c.reset()
    eager = bench.run_bench(cfg, "cuda", capture=False, graph=graph)
    launches = {k: c.count for k, c in counters.items()}
    n_steps = (cfg["warmup"] + eager["rounds"]) * K
    # the first batch's forward, then every step: src and hop 1 gathered,
    # the deepest hop reduced
    want = {"gather_rows": 2 * (n_steps + 1), "segment_spmm": n_steps + 1,
            "sweep_aggregate": 0}
    check(launches == want, "bench %s eager: launches %s, expected %s"
          % (name, launches, want))
    graph = eager["graph"]
    captured = bench.run_bench(cfg, "cuda", capture=True, graph=graph)
    el, gl_ = np.asarray(eager["losses"]), np.asarray(captured["losses"])
    check(el.shape == gl_.shape == (n_steps,)
          and bool(np.isfinite(gl_).all()),
          "bench %s: %s eager and %s graph losses, or one not finite"
          % (name, el.shape, gl_.shape))
    check(np.array_equal(el, gl_), "bench %s: the graph's losses differ "
          "from the eager ones from the same state: max relative %g"
          % (name, np.max(np.abs(el - gl_) / np.abs(el))))
    fresh = EgoGraphSAGE([cfg["feat_dim"], cfg["hidden"], cfg["classes"]],
                         graph[1], agg_type="gcn", device="cuda")
    for p0, pe, pg in zip(fresh.parameters(), eager["model"].parameters(),
                          captured["model"].parameters()):
        check(torch.equal(pe, pg), "bench %s: eager and graph parameters "
              "differ after the same steps" % name)
        check(not torch.equal(p0, pg) and bool(torch.isfinite(pg).all()),
              "bench %s: a parameter did not move or is not finite" % name)

    step = captured["step"]
    seeds0, losses0 = step.graph_seeds[0].clone(), step.losses.clone()
    step()
    seeds1, losses1 = step.graph_seeds[0].clone(), step.losses.clone()
    check(not torch.equal(seeds0, seeds1) and not torch.equal(losses0,
                                                              losses1)
          and int(seeds1.min()) >= 0 and int(seeds1.max()) < cfg["n_nodes"],
          "bench %s: two replays drew the same seeds or gave the same "
          "losses" % name)
    graph_work, graph_busy, graph_by_name = bench_work(torch, step, K, 2)
    check(graph_work == {"gather_rows": 2.0, "segment_spmm": 1.0,
                         "sweep_aggregate": 0.0},
          "bench %s: kernels per replayed step %s; want 2 gather_rows and "
          "1 segment_spmm" % (name, graph_work))
    eager_work, eager_busy, _ = bench_work(torch, step.run_eager, K, 1)
    check(eager_work == graph_work, "bench %s: kernels per eager step %s, "
          "per replayed step %s" % (name, eager_work, graph_work))
    edges = b * (k1 + k1 * k2)
    log("bench %s (%d nodes, %d edges, fanout [%d, %d], batch %d, K = %d, G "
        "= %d, %d steps after %d warm-up calls): eager %.4f ms per step "
        "(%.4g edges/s, device busy %.4f ms, %.1f%%), CUDA graph %.4f ms per "
        "step (%.4g edges/s, device busy %.4f ms, %.1f%%); capture %.3f s, "
        "graph pool %.1f MB; %d losses bit-equal eager and captured (%.4f -> "
        "%.4f); kernels per replayed step %s; host draw %.1f s, CSR build "
        "and tables onto the card %.1f s (%.3f GB), peak allocated %.3f GB "
        "eager, %.3f GB with the graph; card: %s"
        % (name, cfg["n_nodes"], cfg["n_nodes"] * cfg["avg_degree"], k1, k2,
           b, K, captured["G"], captured["rounds"] * K, cfg["warmup"],
           eager["step_ms"], eager["edges_per_s"], eager_busy,
           100.0 * eager_busy / eager["step_ms"], captured["step_ms"],
           captured["edges_per_s"], graph_busy,
           100.0 * graph_busy / captured["step_ms"], captured["capture_s"],
           captured["graph_pool_bytes"] / 1e6, n_steps, gl_[0], gl_[-1],
           {k: v for k, v in graph_work.items() if v}, eager["host_build_s"],
           eager["tables_s"], eager["tables_bytes"] / 1e9,
           eager["device_bytes_peak"] / 1e9,
           captured["device_bytes_peak"] / 1e9, card))
    for kname, ms in sorted(graph_by_name.items(),
                            key=lambda kv: -kv[1])[:10]:
        log("  device %.4f ms per replayed step: %s" % (ms, kname[:90]))
    rows = {k: {"bench_%s_launches_per_step" % name: graph_work[k],
                "bench_%s_eager_launches" % name: launches[k]}
            for k in ("gather_rows", "segment_spmm")}
    del eager, captured, step
    if not sorted_route:
        return rows, graph
    with bench.bench_conf(sorted_gather=True):
        first = bench.run_bench(dict(cfg, steps=K, warmup=1), "cuda",
                                capture=True, graph=graph)
        work, busy, _ = bench_work(torch, first["step"], K, 2)
    check(work == {"gather_rows": 2.0, "segment_spmm": 0.0,
                   "sweep_aggregate": 1.0},
          "bench %s sorted_gather: kernels per replayed step %s; want 2 "
          "gather_rows and 1 sweep_aggregate" % (name, work))
    check(abs(first["losses"][0] - el[0]) <= SORTED_LOSS_RTOL * abs(el[0])
          and bool(np.isfinite(first["losses"]).all()),
          "bench %s sorted_gather: first loss %g, unsorted %g"
          % (name, first["losses"][0], el[0]))
    log("bench %s, conf.sorted_gather on, captured: kernels per replayed "
        "step %s, device busy %.4f ms per step, first loss %.7f (unsorted "
        "%.7f, limit %g relative)"
        % (name, {k: v for k, v in work.items() if v}, busy,
           first["losses"][0], el[0], SORTED_LOSS_RTOL))
    rows["sweep_aggregate"] = {"bench_%s_sorted_launches_per_step" % name:
                               work["sweep_aggregate"]}
    return rows, graph


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch.ops.kernels import (build, gat, gather, spmm,
                                                   sweep)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gl.conf.feature_dtype = "bfloat16"

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    log("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                   torch.cuda.get_device_name(0)))

    t0 = time.perf_counter()
    reports = build.build()
    log("kernels built in %.1f s" % (time.perf_counter() - t0))
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("%s: %s" % (name, line.strip()))

    check_gather(torch, gather)
    check_spmm(torch, spmm)
    check_group_max(torch, gl, spmm)
    check_sweep(torch, sweep)
    check_gat(torch, gat)
    rows = measure_kernels(torch, gather, spmm)
    rows["gat_block"] = measure_gat(torch, gat)

    t0 = time.perf_counter()
    g, dec = gl.synthetic_graph(N_NODES, AVG_DEGREE, FEAT_DIM, CLASSES,
                                seed=0, device="cuda")
    log("graph (%d nodes, %d edges) built in %.1f s"
        % (N_NODES, N_NODES * AVG_DEGREE, time.perf_counter() - t0))
    launches = serving_path(torch, card, g, dec, gather, spmm)
    sage_launches, gat_launches = training_path(torch, card, g, dec, gather,
                                                spmm, gat)
    ragged_launches = full_store_queries(torch, g, spmm)
    filtered_queries(torch, g)
    from graph_learn_tpu_torch import bench
    bench_rows, _ = bench_path(torch, card, bench.CFG, (g, dec), gather,
                               spmm, sweep, "cfg", sorted_route=True)
    del g, dec
    gc.collect()  # the 200k graph's tables (Graph, Dag and Query form cycles)
    rows["sweep_aggregate"], rows["stream_sum"], bar = sweep_rows(
        torch, card, sweep, spmm)
    rows["segment_spmm"].update(bar)
    torch.cuda.empty_cache()
    scale_launches, sorted_launches, extra = scale_path(torch, card, gl,
                                                        gather, spmm, sweep)
    gc.collect()  # the 62M graph of scale_path
    torch.cuda.empty_cache()
    with bench.bench_conf(storage_profile="minimal"):
        scale_rows, scale_graph = bench_path(
            torch, card, bench.CFG_SCALE, None, gather, spmm, sweep,
            "cfg_scale")
    et = scale_graph[0].store.edge_table("rel")
    check(et.weights is not None and et.num_edges == 61_250_000,
          "bench cfg_scale: not the weighted 61.25M-edge graph")
    del scale_graph, et
    for part in (bench_rows, scale_rows):
        for kname, fields in part.items():
            extra.setdefault(kname, {}).update(fields)
    # `launches`: each from the run of the path named, which started from
    # zero: the serving phase for gather_rows and segment_spmm, the EgoGAT
    # training run for gat_block, the sorted-gather 62M run for
    # sweep_aggregate, the harness for stream_sum
    kernels = []
    for name in ("gather_rows", "segment_spmm"):
        rows[name]["launches"] = launches[name]
        rows[name]["train_launches"] = (sage_launches[name]
                                        + gat_launches[name])
        rows[name]["scale_launches"] = (scale_launches[name]
                                        + sorted_launches[name])
        kernels.append(rows[name])
    rows["segment_spmm"]["ragged_launches"] = ragged_launches
    rows["gat_block"]["launches"] = gat_launches["gat_block"]
    rows["gat_block"]["bwd_launches"] = gat_launches["gat_block_bwd"]
    check(gat_launches["gat_block"] > 0 and gat_launches["gat_block_bwd"] > 0,
          "gat_block was never launched by the training path")
    kernels.append(rows["gat_block"])
    rows["sweep_aggregate"]["launches"] = sorted_launches["sweep_aggregate"]
    for name in ("sweep_aggregate", "stream_sum"):
        check(rows[name]["launches"] > 0, name + " was never launched by "
              "its path")
        kernels.append(rows[name])
    for name, fields in extra.items():
        rows[name].update(fields)
    check_bounds(kernels)
    log("every phase passed in %.1f s" % (time.perf_counter() - t_start))

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
