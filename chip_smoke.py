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
   dtypes, widths, ragged sizes and degrees, and time kernel, plain version
   and one library call at the serving path's shapes;
4. run the serving path at the benchmark's width: the 200k-node / 3.2M-edge
   synthetic graph with bf16 features, the 2-hop EgoSAGE query installed on
   QueryService(micro_batch=1024), several client threads sending raw-id
   requests, and EgoGraphSAGE([128, 256, 32], agg "gcn") on every answer:
   the rows of the source and first hop gathered by the gather kernel, the
   deepest hop reduced by the segment SpMM kernel.  Sampled ids, features
   and logits are checked, and both kernels' launch counters must have
   moved during this phase;
5. show where one caller's request goes: the host wall of the request and
   of the forward, and the device time by kernel (torch.profiler).

The last two lines of standard output are the card line and the JSON
object {"ok": true, "device": {...}}; the {"kernels": [...]} line comes
just before them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the f32
# rate outside the tensor cores, for the kernels' least possible time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# Benchmark configuration of the serving path (bench.py CFG).
N_NODES, AVG_DEGREE, FEAT_DIM, HIDDEN, CLASSES = 200_000, 16, 128, 256, 32
FANOUT = (15, 10)
MICRO_BATCH = 1024
N_CLIENTS, REQUESTS_PER_CLIENT = 8, 32


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
    """Mean time of one call over ``iters`` back-to-back calls, between two
    CUDA events.  Without ``hold`` the host launches as the card runs, so a
    call that is quicker on the card than on the host is timed at the
    host's launch rate.  With ``hold`` the stream first spins while the host
    queues every call, so the result is the card's time alone.  The spin
    starts at about 20 ms; when the host took longer than the spin to queue
    the calls (a slow or busy host), the measurement is taken again with a
    spin of twice the host's queueing time, and the run fails if three
    tries never held the card.  Keep ``iters`` times the launches of one
    call well below the CUDA launch queue's depth (about a thousand), or
    the host blocks on the full queue whatever the spin."""
    import torch
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
        log("timing: the host took %s; again with a longer spin" % tries[-1])
        spin_cycles = int(spin_cycles * 2.0 * enqueue_ms / spin_ms)
    raise SmokeFailure("timing: the host took longer to queue %d calls than "
                       "the card spun, in every try: %s"
                       % (iters, "; ".join(tries)))


def time_cold_ms(fn, iters=20) -> float:
    """Median device time of one call after the L2 was flushed (a 256 MiB
    write, over five times the H100's 50 MB L2); one call per pair of
    events, so its launch is included."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_gather(torch, gather):
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        for d in (128, 100, 7):
            table = torch.randn((20_000, d), generator=gen, device="cuda",
                                dtype=torch.float32).to(dtype)
            for m in (1, 33, 4097, 153_600):
                idx = torch.randint(0, table.shape[0], (m,), generator=gen,
                                    device="cuda", dtype=torch.int32)
                out = gather.gather_rows(table, idx)
                torch.cuda.synchronize()
                check(torch.equal(out, gather.gather_rows_plain(table, idx)),
                      "gather_rows != plain (%s, D=%d, M=%d)" % (dtype, d, m))
    log("gather_rows: exact on bf16/f32, D in {128, 100, 7}, "
        "M in {1, 33, 4097, 153600}")


def check_spmm(torch, spmm):
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, cap = 777, 10
    worst = 0.0
    for in_dtype in (torch.bfloat16, torch.float32):
        for out_dtype in (torch.float32, in_dtype):
            # f32 out: only the order of the f32 sums differs; bf16 out:
            # that difference may flip one bf16 rounding (2^-8 relative)
            rtol, atol = ((1e-5, 1e-5) if out_dtype == torch.float32
                          else (2 ** -7, 1e-5))
            for d in (128, 100):
                feats = torch.randn((5_000, d), generator=gen, device="cuda",
                                    dtype=torch.float32).to(in_dtype)
                ids = torch.randint(0, 5_000, (b, cap), generator=gen,
                                    device="cuda", dtype=torch.int32)
                deg = torch.randint(0, cap + 1, (b,), generator=gen,
                                    device="cuda", dtype=torch.int32)
                deg[:3] = torch.tensor([0, cap, 1], dtype=torch.int32)
                for agg in spmm.AGGS:
                    out = spmm.segment_spmm(feats, ids, deg, agg, out_dtype)
                    ref = spmm.segment_spmm_plain(feats, ids, deg, agg,
                                                  out_dtype)
                    torch.cuda.synchronize()
                    check(out.dtype == out_dtype and out.shape == (b, d),
                          "segment_spmm dtype/shape")
                    ok = torch.allclose(out.float(), ref.float(), rtol=rtol,
                                        atol=atol)
                    err = (out.float() - ref.float()).abs().max().item()
                    check(ok, "segment_spmm %s %s->%s D=%d: max err %g"
                          % (agg, in_dtype, out_dtype, d, err))
                    worst = max(worst, err)
    log("segment_spmm: sum/mean/max/min, bf16/f32 in, f32/in-dtype out, "
        "D in {128, 100}, degrees 0..cap within tolerance (f32 out rtol=atol"
        "=1e-5; bf16 out rtol=2^-7, atol=1e-5); max abs err %g" % worst)


def measure_kernels(torch, gather, spmm):
    """Time each kernel, its plain version and one library call at the
    serving path's deepest-hop shapes."""
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
    g_bytes = 2 * m * FEAT_DIM * table.element_size() + m * 4
    g_bound, g_by = bound(g_bytes, 0)
    rows = {
        "gather_rows": dict(
            name="gather_rows", route="cuda",
            source="graph_learn_tpu_torch/csrc/gather.cu",
            replaces="graph_learn_tpu/ops/pallas/gather.py:64",
            max_abs_err=g_err,
            ms=time_ms(lambda: gather.gather_rows(table, idx), hold=True),
            plain_ms=time_ms(lambda: gather.gather_rows_plain(table, idx),
                             iters=20, hold=True),
            bound_ms=g_bound, bound_by=g_by,
            library_ms=time_ms(lambda: torch.index_select(table, 0, idx),
                               hold=True)),
    }
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
        ms=time_ms(lambda: spmm.segment_spmm(table, ids, deg, "mean",
                                             torch.float32), hold=True),
        plain_ms=time_ms(lambda: spmm.segment_spmm_plain(
            table, ids, deg, "mean", torch.float32), iters=20, hold=True),
        bound_ms=s_bound, bound_by=s_by,
        library_ms=time_ms(lambda: F.embedding_bag(ids, table, mode="mean"),
                           hold=True))
    cold = {"gather_rows": time_cold_ms(lambda: gather.gather_rows(table,
                                                                  idx)),
            "segment_spmm": time_cold_ms(lambda: spmm.segment_spmm(
                table, ids, deg, "mean", torch.float32))}
    for r in rows.values():
        log("%s at the serving shape: %.4f ms warm L2, %.4f ms cold L2 "
            "(plain %.4f, library %.4f, bound %.4f by %s), max abs err %g "
            "(held: gather exact, spmm rtol=atol=1e-5)"
            % (r["name"], r["ms"], cold[r["name"]], r["plain_ms"],
               r["library_ms"], r["bound_ms"], r["bound_by"],
               r["max_abs_err"]))
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the serving path at the benchmark's width
# ---------------------------------------------------------------------------


def serving_path(torch, card, gather, spmm):
    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch.core.values import DeferredRows
    from graph_learn_tpu_torch.nn.data import EgoGraph
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gl.conf.feature_dtype = "bfloat16"
    k1, k2 = FANOUT
    t0 = time.perf_counter()
    g, dec = gl.synthetic_graph(N_NODES, AVG_DEGREE, FEAT_DIM, CLASSES,
                                seed=0, device="cuda")
    q = (g.V("item").batch(MICRO_BATCH).alias("src")
         .outV("rel").sample(k1).by("random").alias("hop1")
         .outV("rel").sample(k2).by("random").alias("hop2").values())
    svc = gl.QueryService(g, device="cuda")
    qid = svc.install(q, micro_batch=MICRO_BATCH)
    table = q.device_tables()["nodes"]["item"].float_attrs
    model = EgoGraphSAGE([FEAT_DIM, HIDDEN, CLASSES], dec, agg_type="gcn",
                         device="cuda")
    model.eval()
    log("graph (%d nodes, %d edges) built and installed in %.1f s"
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
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + dev_us / 1e3
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from graph_learn_tpu_torch.ops.kernels import build, gather, spmm

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
    rows = measure_kernels(torch, gather, spmm)

    launches = serving_path(torch, card, gather, spmm)
    kernels = []
    for name in ("gather_rows", "segment_spmm"):
        rows[name]["launches"] = launches[name]
        kernels.append(rows[name])

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
