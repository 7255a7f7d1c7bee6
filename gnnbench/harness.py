"""One run of one cell: set-up, the measured window, the optional trace,
the comparison with the plain reference, and the result line.

    python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--control 1] [--catalog DIR] [--spec FILE]

The depth is the workload's: a ``traffic.fanout`` of length N samples N
hops, "hop1" ... "hopN", and a model of N layers runs on them.  The
model's step is ``models/<model>.py`` and its plain reference
``references/<model>.py``, both found by the configuration's ``model``
(``catalog.py``).

Set-up (``setup_s``: from the process's start to the first timed step):
the graph drawn from ``--seed`` on the device by the workload's generator
and copied to the host; the port's store built from those arrays
(``Graph`` tables, the CSR on the host, ``device_tables``:
``store_build_s``); the model with weights drawn on the device from the
seed; the port's K-step function, whose first call runs K steps eagerly
(the steps the reference follows) and captures them in one CUDA graph;
two replays.  The window replays the graph for ``--seconds``, at most two
calls in flight, and ends with one synchronise.

After the window (and after the peak is read) the parameters and Adam's
state are copied to the host, and the graph is replayed once more: that
replay's K steps are the ones the reference follows from the copy.
``--trace 1`` then traces a few replays and K eager steps (``trace.py``)
and reports the per-layer metrics instead of the end-to-end ones.

Then the program's state is freed and the reference (``reference.py``
with the model's ``references/<model>.py``) checks, on the same device:
every sampled id of the first call's K steps and of that replay's K steps
against the CSR rebuilt from the edge arrays, hop by hop (seeds -> hop 1
-> ... -> hop N); hop N's means (Kernel 2's) of the first three steps and
of the replay's first and last steps; the first step's logits, the three
steps' losses, the first gradient (Adam's first moment after step 1) and
the parameters' change after step 3 against the reference's own three
steps from the same weights and ids; and the replay's first logits, its K losses and the
parameters' change over it against the reference's K steps from the
copied parameters and Adam state (``replay_*``).  Each gradient and update
gap is read by its worst leaf and by its median leaf.  The
configuration's ``limits`` (or the workload's) name the numbers compared,
each with its limit; ``correct`` is every one within its limit, and the
others are printed as readings.  ``--control 1`` also prints the numbers
of the control (the reference computed with TF32 products in the
program's place) and of a half batch (the loss over half the seeds, each
of hop N's means over half its rows), which set the limits; the
benchmark's own runs never pass it.

No card (``torch.cuda.is_available()``, or fewer cards than the cell
asks for): exit 2 and no result.  ``GLT_PLATFORM=cpu`` runs the whole
run on the CPU instead, for a rehearsal at a test's size; its line says
``"platform": "cpu"``.  A module of JAX or of the JAX package loaded by
the end of the run: exit 3 and no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import sys
import time
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "graph_learn_tpu")
WARM_REPLAYS = 2
TRACE_WINDOW_S = 0.3


def log(msg: str):
    print("[gnnbench] " + msg, file=sys.stderr, flush=True)


def parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the control's and a half batch's "
                         "numbers (to set the limits)")
    ap.add_argument("--catalog", action="append", default=[],
                    help="another directory of configs/, workloads/, ...")
    ap.add_argument("--spec", help="a BENCHMARK.json other than the root's")
    return ap.parse_args(argv)


def sub_seed(seed: int, k: int) -> int:
    """The ``k``-th seed drawn from the run's ``seed``."""
    return (seed * 0x9E3779B1 + 0x632BE5AB * k) % (1 << 63)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv: Optional[List[str]] = None,
         t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    from gnnbench.catalog import Catalog
    cat = Catalog(args.catalog, args.spec)
    cell = cat.cell(args.workload)
    import torch
    on_cpu = os.environ.get("GLT_PLATFORM") == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            log("no CUDA card: torch.cuda.is_available() is false")
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            log("the cell asks for %d cards, %d present"
                % (cell["chips"], torch.cuda.device_count()))
            return 2
    dev = torch.device("cpu") if on_cpu else torch.device("cuda", 0)
    result = run(cat, cell, args, dev, t_start)
    found = forbidden_modules()
    if found:
        log("modules of JAX or the JAX package were loaded: %s" % found)
        return 3
    compared = result["compared"]
    for k, v in compared.items():
        print("compared %s %r limit %r" % (k, v["value"], v["limit"]),
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def run(cat, cell: dict, args, dev, t_start: float) -> dict:
    import numpy as np
    import torch

    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.core.schema import Decoder
    from graph_learn_tpu_torch.core.store import EdgeTable, NodeTable
    from graph_learn_tpu_torch.graph import Graph
    from graph_learn_tpu_torch.ops.kernels import build

    from gnnbench import flops, reference
    from gnnbench import trace as tracing
    from gnnbench.readers import Context
    from gnnbench.steps import hop_aliases, host_copy

    cuda = dev.type == "cuda"
    wl = cat.workload(cell["name"])
    cfg = cat.config(cell["config"])
    traffic = wl["traffic"]
    gparams = {**cfg["graph"], **wl.get("graph", {})}
    n = int(gparams["nodes"])
    b = traffic["batch"]
    fanout = traffic["fanout"]
    hops = hop_aliases(fanout)
    model_mod = cat.module("models", cfg["model"])
    logits_fn = cat.module("references", cfg["model"]).logits
    peaks = flops.load_peaks(cfg["peak"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- set-up --------------------------------------------------------
    compile_s = 0.0
    if cuda:
        t0 = time.perf_counter()
        build.build()  # every kernel from the checkout's cache, or nvcc
        compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = cat.module("graphs", wl["generator"]).generate(
        gparams, sub_seed(args.seed, 0), dev)
    gen_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with bench.bench_conf(feature_dtype=cfg["feature_dtype"],
                          storage_profile=cfg["storage_profile"],
                          default_neighbor_id=cfg["fill_id"]):
        t0 = time.perf_counter()
        d = int(gparams["feat_dim"])
        dec = Decoder(labeled=True, attr_types=["float"] * d)
        g = Graph(device=dev)
        g.add_node_table(NodeTable(
            "item", dec, np.arange(n, dtype=np.int64),
            float_attrs=data["features"], labels=data["labels"]))
        g.add_edge_table(EdgeTable(
            "rel", "item", "item", Decoder(weighted=True), src=data["src"],
            dst=data["dst"], num_src_nodes=n, num_dst_nodes=n,
            weights=data["weights"]))
        q = g.V("item").batch(b).alias("src")
        for k, alias in zip(fanout, hops):
            q = q.outV("rel").sample(k).by(traffic["strategy"]).alias(alias)
        q = q.values()
        tables = q.device_tables(dev)
        if cuda:
            torch.cuda.synchronize()
        store_build_s = time.perf_counter() - t0
        table = tables["nodes"]["item"].float_attrs

        model = model_mod.build(cfg, dec, dev)
        params0 = draw_weights(model, model_mod.ref_name,
                               sub_seed(args.seed, 1), dev)
        optimizer = bench.make_optimizer(model, dev, lr=cfg["lr"])
        gen = torch.Generator(device=dev).manual_seed(sub_seed(args.seed, 2))
        K = traffic["steps_per_call"]
        step = model_mod.Steps(q, tables, model, optimizer,
                               {"scan_steps": K, "n_nodes": n},
                               traffic["group"], gen, cuda, hops=hops,
                               beta1=cfg["adam_betas"][0])
        step()  # K eager steps (kept for the reference), then the capture
        for _ in range(WARM_REPLAYS if cuda else 0):
            step()
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        log("set-up %.3fs: compile %.3fs, graph drawn %.3fs, store %.3fs"
            % (setup_s, compile_s, gen_s, store_build_s))

        # ---- the window ------------------------------------------------
        calls, prev = 0, None
        t0 = time.perf_counter()
        while True:
            step()
            calls += 1
            if cuda:
                done = torch.cuda.Event()
                done.record()
                if prev is not None:
                    prev.synchronize()
                prev = done
            if time.perf_counter() - t0 >= args.seconds:
                break
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        last_losses = step.losses.detach().cpu()
        peak = (torch.cuda.max_memory_allocated(dev) if cuda else None)

        # ---- one more replay, which the reference follows --------------
        before = adam_state(model, optimizer, model_mod.ref_name)
        step()
        replay = {"steps": [{k: host_copy(v) for k, v in r.items()}
                            for r in step.replayed],
                  "losses": step.losses.detach().cpu(), **before,
                  "after": {model_mod.ref_name(k): host_copy(p)
                            for k, p in model.named_parameters()}}
        steps = calls * K
        # the sampled edges of a seed's tree: k1 + k1 k2 + ... + k1 ... kN
        edges = steps * b * sum(math.prod(fanout[:j])
                                for j in range(1, len(fanout) + 1))
        work = model_mod.step_work(cfg, traffic)
        log("window %.6fs: %d calls of %d steps, %.1f steps/s"
            % (wall, calls, K, steps / wall))

        # ---- the traced run -------------------------------------------
        summary, kernel_work = None, {}
        if args.trace and cuda:
            replays = max(3, math.ceil(TRACE_WINDOW_S / (wall / calls)))
            summary = tracing.record(step, replays)
            for rec in step.traced:
                for op, works in model_mod.kernel_work(
                        cfg, traffic, rec, table.element_size()).items():
                    kernel_work.setdefault(op, []).extend(works)
            log("trace: %r" % (summary,))

        kept = {"first": step.first,
                "grads": {model_mod.ref_name(k): v
                          for k, v in step.first_grads.items()},
                "params": {model_mod.ref_name(k): v
                           for k, v in step.first_params.items()},
                "replay": replay}
        del step, model, optimizer, tables, table, q, g
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the comparison -------------------------------------------------
    t0 = time.perf_counter()
    numbers, extra = compare(reference, logits_fn, cfg, traffic, hops, data,
                             kept, params0, dev, args.control)
    limits = {**cfg["limits"], **wl.get("limits", {})}
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError("limits for numbers this cell does not read: %s"
                       % sorted(missing))
    for k, v in numbers.items():
        if k not in limits:
            log("read, not compared: %s %r" % (k, v))
    finite = bool(torch.isfinite(last_losses).all()
                  and torch.isfinite(replay["losses"]).all())
    correct = finite and steps > 0 and all(
        numbers[k] <= lim for k, lim in limits.items())
    log("comparison %.3fs" % (time.perf_counter() - t0))
    if extra:
        log("calibration %s" % json.dumps(extra))

    # ---- the result ----------------------------------------------------
    ctx = Context(trace=summary, step_work=work, kernel_work=kernel_work,
                  peaks=peaks, store_build_s=store_build_s)
    values: Dict[str, float] = {}
    if args.trace:
        for m in cat.metrics(cell["name"], traced=True):
            v = cat.module("metrics", m["name"]).read(ctx)
            if v is not None:
                values[m["name"]] = v
    else:
        e2e = {"train_edges_per_s": edges / wall,
               "train_mfu": 100.0 * steps * flops.compute_s(work, peaks)
               / wall,
               "setup_s": setup_s}
        if peak is not None:
            e2e["device_peak_gib"] = peak / 2 ** 30
        for m in cat.metrics(cell["name"], traced=False):
            if m["name"] in e2e:
                values[m["name"]] = e2e[m["name"]]
    units = {m["name"]: m["unit"]
             for m in cat.spec["end_to_end"] + cat.spec["per_layer"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1,
              "memory_peak_bytes": peak if cuda else 0}
    out = {"correct": correct, "attempted": steps,
           "failed": int((~torch.isfinite(last_losses)).sum()),
           "metrics": {k: {"value": v, "unit": units[k]}
                       for k, v in values.items()},
           "device": device}
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    if extra:
        out["calibration"] = extra
    out["compared"] = {k: {"value": numbers[k], "limit": lim}
                       for k, lim in limits.items()}
    return out


def draw_weights(model, ref_name, seed: int, dev) -> Dict[str, "object"]:
    """Every leaf LeCun-normal (std = fan_in ** -0.5, fan_in = the in
    features of the Linear the weight or bias belongs to), drawn on the
    device in one call from ``seed`` and copied into ``model``; returns
    the benchmark's own copy on the host, by the reference's leaf
    names."""
    import torch
    named = list(model.named_parameters())
    shapes = dict(named)
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(sum(p.numel() for _, p in named), generator=gen,
                       device=dev)
    out, off = {}, 0
    with torch.no_grad():
        for name, p in named:
            weight = (p if p.dim() == 2
                      else shapes[name.rsplit(".", 1)[0] + ".weight"])
            w = flat[off:off + p.numel()].view_as(p) * weight.shape[1] ** -0.5
            off += p.numel()
            p.copy_(w)
            out[ref_name(name)] = w.cpu()
    return out


def adam_state(model, optimizer, ref_name) -> dict:
    """The parameters ("before") and Adam's state ("state": "exp_avg",
    "exp_avg_sq" by leaf, "step") copied to the host, by the reference's
    leaf names."""
    from gnnbench.steps import host_copy
    import torch
    params, m, v, steps = {}, {}, {}, set()
    for name, p in model.named_parameters():
        st, k = optimizer.state.get(p, {}), ref_name(name)
        params[k] = host_copy(p)
        m[k], v[k] = (host_copy(st.get(a, torch.zeros_like(p)))
                      for a in ("exp_avg", "exp_avg_sq"))
        steps.add(float(st.get("step", 0)))  # no state: no step taken
    if len(steps) != 1:
        raise ValueError("Adam's leaves took different steps: %s" % steps)
    return {"before": params,
            "state": {"exp_avg": m, "exp_avg_sq": v, "step": steps.pop()}}


def compare(reference, logits_fn, cfg: dict, traffic: dict, hops, data: dict,
            kept: dict, params0: dict, dev, control: bool):
    """The numbers compared (module note) and, with ``control``, the
    control's and the half batch's.  ``logits_fn`` is the model's
    reference logits; ``hops`` the aliases "hop1" ... "hopN"."""
    import torch
    first, replay = kept["first"], kept["replay"]
    index = reference.EdgeIndex(data["src"], data["dst"],
                                data["features"].shape[0], dev)
    fill = cfg["fill_id"]
    chain = ("seeds",) + tuple(hops)
    deepest = chain[-1]
    bad = 0
    for rec in first + replay["steps"]:
        ids = [rec[a].to(dev) for a in chain]
        bad += index.bad_seeds(ids[0]) + sum(
            index.bad_children(parent, child, fill)
            for parent, child in zip(ids, ids[1:]))
    del index
    feats = torch.from_numpy(data["features"]).to(dev)
    labels = torch.from_numpy(data["labels"]).to(dev)
    numbers = {"bad_samples": bad}
    followed = [r for r in first if "logits" in r]
    with_agg = [r for r in followed + replay["steps"] if "agg" in r]
    if with_agg:
        numbers["agg_gap"] = max(
            reference.rel_max_gap(r["agg"], reference.group_mean(
                feats, r[deepest].to(dev)))
            for r in with_agg)

    def on_dev(leaves):
        return {k: v.to(dev) for k, v in leaves.items()}

    def ids(recs):
        return [{a: r[a].to(dev).long() for a in chain} for r in recs]

    state = {"exp_avg": on_dev(replay["state"]["exp_avg"]),
             "exp_avg_sq": on_dev(replay["state"]["exp_avg_sq"]),
             "step": replay["state"]["step"]}
    # prefix: (the program's readings, start weights, Adam state, ids)
    runs = {"": ({"losses": [float(r["loss"]) for r in followed],
                  "logits": followed[0]["logits"], "grads": kept["grads"],
                  "params": kept["params"]}, on_dev(params0), None,
                 ids(followed)),
            "replay_": ({"losses": replay["losses"].tolist(),
                         "logits": replay["steps"][0]["logits"],
                         "grads": None, "params": replay["after"]},
                        on_dev(replay["before"]), state,
                        ids(replay["steps"]))}
    extra = {}
    for prefix, (prog, start, st, batches) in runs.items():
        ref = reference.follow(logits_fn, cfg, start, feats, labels,
                               batches, cfg["lr"], state=st)
        numbers.update(model_numbers(reference, prog, ref, start, dev,
                                     prefix))
        log_leaves(reference, prog, ref, start, dev, prefix)
        if not control:
            continue
        for name, kw in (("control_tf32", {"tf32": True}),
                         ("half_batch", {"rows": traffic["batch"] // 2})):
            other = reference.follow(logits_fn, cfg, start, feats,
                                     labels, batches, cfg["lr"], state=st,
                                     **kw)
            if prog["grads"] is None:
                other["grads"] = None
            extra.setdefault(name, {}).update(
                model_numbers(reference, other, ref, start, dev, prefix))
    if control and "agg_gap" in numbers:  # each mean over half its rows
        extra["half_batch"]["agg_gap"] = max(
            reference.rel_max_gap(
                reference.group_mean(feats, r[deepest].to(dev)[..., :half]),
                reference.group_mean(feats, r[deepest].to(dev)))
            for r in with_agg
            for half in [r[deepest].shape[-1] // 2])
    return numbers, extra


def log_leaves(reference, prog: dict, ref: dict, p0: dict, dev,
               prefix: str):
    """The three worst leaves of the gradient's and the update's gaps, on
    standard error."""
    gaps = {"update": reference.leaf_gaps(
        {k: prog["params"][k].to(dev) - p0[k] for k in p0},
        {k: ref["params"][k] - p0[k] for k in p0},
        reference.moved_leaves(ref["grads"]))}
    if prog["grads"] is not None:
        gaps["gradient"] = reference.leaf_gaps(
            {k: v.to(dev) for k, v in prog["grads"].items()}, ref["grads"])
    norms = reference.leaf_norms(ref["grads"])
    for name, g in gaps.items():
        worst = sorted(g, key=g.get, reverse=True)[:3]
        log("%sworst %s leaves: %s" % (prefix, name, ", ".join(
            "%s %.3g (|g| %.3g)" % (k, g[k], norms[k]) for k in worst)))


def model_numbers(reference, prog: dict, ref: dict, p0: dict, dev,
                  prefix: str = "") -> dict:
    """logit, loss, (where ``prog`` has it) first-gradient and update gaps
    of ``prog`` against ``ref`` (leaves by the reference's names), each
    name after ``prefix``."""
    keep = reference.moved_leaves(ref["grads"])
    delta_p = {k: prog["params"][k].to(dev) - p0[k] for k in p0}
    delta_r = {k: ref["params"][k] - p0[k] for k in p0}
    updates = reference.leaf_gaps(delta_p, delta_r, keep)
    out = {"logit_gap": reference.rel_max_gap(prog["logits"], ref["logits"]),
           "loss_gap": reference.loss_gap(prog["losses"], ref["losses"]),
           "update_gap": max(updates.values()),
           "update_gap_median": statistics.median(updates.values())}
    if prog["grads"] is not None:
        grads = reference.leaf_gaps(
            {k: v.to(dev) for k, v in prog["grads"].items()}, ref["grads"])
        out["grad_gap"] = max(grads.values())
        out["grad_gap_median"] = statistics.median(grads.values())
    return {prefix + k: v for k, v in out.items()}
