"""The host-RAM storage tier against the device tier.

Counterpart of the repository's ``examples/host_tier_bench.py``.  The host
tier (``gsl/dataset.py tier="host"``) trains a graph whose tables stay in
host RAM: sampling on the CPU, only the batch shipped to the card.  This
harness puts a number on what that costs, with the training step the
trainer runs (``LocalTrainer.train``, EgoGraphSAGE "gcn", Adam 1e-3) on
the bench graph (``bench.CFG``: 200 000 nodes, 3.2M edges, batch 1 024,
fanout [15, 10]), in three shapes:

  device    device tier: the plan on the card, every hop's rows gathered
            there (Kernel 1)
  host      host tier: the plan and the row gathers on the CPU from the
            store's CPU views, the whole batch pinned and copied
  host+agg  host tier with the deepest hop reduced on the CPU first
            (``pre_aggregate_hop`` as the batch transform, Kernel 2's
            plain version), so about a tenth of the bytes cross

Each shape prints one line: ``<shape> <edges/s> edges/s <ms> ms/step``
(host clock, ended by a synchronise).

Usage:  python -m graph_learn_tpu_torch.examples.host_tier_bench
            [--small] [--steps N] [--cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from graph_learn_tpu_torch import bench
from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.examples.scale_demo import loss_of, two_hop_query
from graph_learn_tpu_torch.nn.data import pre_aggregate_hop
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
from graph_learn_tpu_torch.nn.trainer import LocalTrainer
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

SHAPES = ("device", "host", "host+agg")
WARMUP_STEPS = 3


def sage_query(g, cfg: dict):
    """The 2-hop ``random`` query over a ``.shuffle()`` source."""
    k1, k2 = cfg["fanout"]
    return (g.V("item").batch(cfg["batch"]).shuffle().alias("src")
            .outV("rel").sample(k1).by("random").alias("hop1")
            .outV("rel").sample(k2).by("random").alias("hop2").values())


def sage_loss(model, batch, generator, training):
    return loss_of(model, batch, generator)


def agg_transform(batch: dict, tables) -> dict:
    """The deepest hop reduced to its group means where the tables are."""
    return pre_aggregate_hop(batch, "hop2",
                             tables["nodes"]["item"].float_attrs, "mean")


def make_model(cfg: dict, dec, device: DeviceLike = "cuda"):
    return EgoGraphSAGE([cfg["feat_dim"], cfg["hidden"], cfg["classes"]],
                        dec, agg_type="gcn", device=device,
                        generator=torch.Generator().manual_seed(0))


def run_shape(g, dec, cfg: dict, shape: str, steps: int,
              device: DeviceLike = "cuda", window: Optional[int] = None,
              model=None) -> dict:
    """``steps`` LocalTrainer steps of one shape after ``WARMUP_STEPS``
    (which build the tier's tables).  ``window`` (default
    ``conf.dataset_capacity``) is the host tier's lookahead.  Returns the
    seconds, ms a step, edges/s, the losses and the model."""
    dev = resolve_device(device)
    q = sage_query(g, cfg)
    model = model if model is not None else make_model(cfg, dec, dev)
    opt = torch.optim.Adam(model.parameters(), lr=bench.LEARNING_RATE)
    tr = LocalTrainer(seed=1, device=dev)
    losses = []

    def loss_fn(m, batch, generator, training):
        loss = sage_loss(m, batch, generator, training)
        losses.append(loss.detach())
        return loss

    kw = dict(verbose=False, tier="device" if shape == "device" else "host",
              batch_transform=agg_transform if shape == "host+agg" else None)
    with bench.bench_conf(dataset_capacity=window or conf.dataset_capacity):
        tr.train(q, model, loss_fn, opt, steps_per_epoch=WARMUP_STEPS, **kw)
        bench._sync(dev)
        del losses[:]
        t0 = time.perf_counter()
        tr.train(q, model, loss_fn, opt, steps_per_epoch=steps, **kw)
        bench._sync(dev)
        dt = time.perf_counter() - t0
    k1, k2 = cfg["fanout"]
    edges = cfg["batch"] * (k1 + k1 * k2) * steps
    return {"seconds": dt, "ms_step": dt / steps * 1e3,
            "edges_per_s": edges / dt, "losses": torch.stack(losses),
            "model": model}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = dict(bench.CFG_SMALL if args.small else bench.CFG)
    with bench.bench_conf(feature_dtype="bfloat16"):
        g, dec = bench.build_graph(cfg, dev)
        for shape in SHAPES:
            r = run_shape(g, dec, cfg, shape, args.steps, dev)
            print("%-9s %.1f edges/s  %.3f ms/step"
                  % (shape, r["edges_per_s"], r["ms_step"]), flush=True)


if __name__ == "__main__":
    main()
