"""Does the host tier's window overlap sampling with the card's steps?

Counterpart of ``examples/host_overlap_probe.py`` (``main:33-135``).  The
host tier (``Dataset(q, tier="host")``) samples on the CPU from the
store's CPU views and ships each batch to the card; with a window above
1 a producer thread makes the next batches while the caller's thread
runs the step.  This probe measures, on the port bench's ``CFG`` store
(200 000 nodes, 3.2M weighted edges, bf16 features, batch 1 024, fanout
[15, 10]; ``--small``: 20 000 nodes, batch 256, 64 wide), with
EgoGraphSAGE "gcn", dropout 0, Adam 1e-3:

  t_host   ms of one host-tier batch made and shipped synchronously
           (window 1, the card synchronised after each)
  t_dev    ms of one train step on an already shipped batch (the loss
           pulled once after the timed steps)
  t_loop   ms a step of the real loop: ``Dataset(tier="host",
           window=w)`` feeding the step, the loss pulled once at the end,
           for each window w (default 1, 2 and 4)

  overlap factor = (t_host + t_dev) / t_loop
    1.0x  = no overlap
    ceiling = (t_host + t_dev) / max(t_host, t_dev)

A host-tier batch arrives with every feature row gathered on the CPU, and
the model reduces its deepest hop itself, so the loop launches Kernels 1
and 2 zero times (``launches`` in the result).  Times are on the host
clock.

Usage:  python -m graph_learn_tpu_torch.examples.host_overlap_probe
            [--small] [--steps N] [--window 1,2,4] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Sequence

import torch

from graph_learn_tpu_torch import bench
from graph_learn_tpu_torch.errors import OutOfRangeError
from graph_learn_tpu_torch.examples.scale_demo import loss_of, two_hop_query
from graph_learn_tpu_torch.gsl.dataset import Dataset
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
from graph_learn_tpu_torch.ops.kernels import gather, spmm
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

WARM = 3
SMALL = dict(n_nodes=20_000, batch=256, feat_dim=64, hidden=64)


def probe_cfg(small: bool) -> dict:
    """``bench.CFG``; with ``small`` the JAX script's small sizes."""
    cfg = dict(bench.CFG)
    if small:
        cfg.update(SMALL)
    return cfg


def _next(ds: Dataset):
    """The next batch; an epoch's end starts the next epoch."""
    try:
        return ds.next_with_count()[0]
    except OutOfRangeError:
        return ds.next_with_count()[0]


def overlap(t_host: float, t_dev: float, t_loop: float) -> float:
    return (t_host + t_dev) / t_loop


def ceiling(t_host: float, t_dev: float) -> float:
    return (t_host + t_dev) / max(t_host, t_dev)


def run(cfg: Optional[dict] = None, steps: int = 30,
        windows: Sequence[int] = (1, 2, 4), device: DeviceLike = "cuda"
        ) -> Dict[str, object]:
    """Build the bench graph of ``cfg``, then measure ``t_host``, ``t_dev``
    and, for each window, ``t_loop`` (ms) and the overlap factor; count
    Kernels 1-2's launches over the whole run."""
    dev = resolve_device(device)
    cfg = probe_cfg(False) if cfg is None else cfg
    g, dec = bench.build_graph(cfg, dev)
    k1, k2 = cfg["fanout"]
    edges = cfg["batch"] * (k1 + k1 * k2)
    q = two_hop_query(g, cfg["batch"], (k1, k2))
    counters = {"gather_rows": gather.LAUNCHES, "segment_spmm": spmm.LAUNCHES}
    before = {k: c.count for k, c in counters.items()}

    def fresh():
        model = EgoGraphSAGE([cfg["feat_dim"], cfg["hidden"], cfg["classes"]],
                             dec, agg_type="gcn", dropout=0.0, device=dev,
                             generator=torch.Generator().manual_seed(0))
        return model, bench.make_optimizer(model, dev)

    def step(model, opt, batch):
        loss = loss_of(model, batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    # t_host: window 1, each batch finished before the next is made
    ds = Dataset(q, tier="host", seed=2, window=1, device=dev)
    batches = []
    for _ in range(WARM):
        batches.append(_next(ds))
        bench._sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        _next(ds)
        bench._sync(dev)
    t_host = (time.perf_counter() - t0) / steps
    ds.close()

    # t_dev: the step alone on batches already on the card
    model, opt = fresh()
    for _ in range(WARM):
        loss = step(model, opt, batches[0])
    float(loss)
    t0 = time.perf_counter()
    for i in range(steps):
        loss = step(model, opt, batches[i % len(batches)])
    float(loss)  # the one pull: a true barrier
    t_dev = (time.perf_counter() - t0) / steps

    out: Dict[str, object] = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"), "steps": steps, "t_host_ms": t_host * 1e3,
        "t_dev_ms": t_dev * 1e3, "ceiling": ceiling(t_host, t_dev),
        "windows": []}
    for w in windows:
        ds = Dataset(q, tier="host", seed=3, window=w, device=dev)
        model, opt = fresh()
        for _ in range(WARM):
            loss = step(model, opt, _next(ds))
        float(loss)
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step(model, opt, _next(ds))
        float(loss)
        t_loop = (time.perf_counter() - t0) / steps
        ds.close()
        out["windows"].append({
            "window": w, "t_loop_ms": t_loop * 1e3,
            "overlap": overlap(t_host, t_dev, t_loop),
            "edges_per_s": edges / t_loop})
    out["launches"] = {k: c.count - before[k] for k, c in counters.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--window", default="1,2,4")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    dtype = os.environ.get("GLT_FEATURE_DTYPE", "bfloat16")
    with bench.bench_conf(feature_dtype=dtype):
        r = run(probe_cfg(args.small), args.steps,
                [int(x) for x in str(args.window).split(",")], dev)
    print("t_host %.1f ms  t_dev %.1f ms  (overlap ceiling %.2fx; %s)"
          % (r["t_host_ms"], r["t_dev_ms"], r["ceiling"], r["device"]),
          flush=True)
    for x in r["windows"]:
        print("window=%d  t_loop %.1f ms  overlap %.2fx  %.2fM edges/s"
              % (x["window"], x["t_loop_ms"], x["overlap"],
                 x["edges_per_s"] / 1e6), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
