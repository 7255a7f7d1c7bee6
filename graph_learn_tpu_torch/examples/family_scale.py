"""The model families at the 61M-edge scale: the bipartite u2i family.

Counterpart of ``examples/family_scale.py`` for its ``bipartite`` family
(``run_bipartite:164-281``): bipartite SAGE u2i link prediction on the
store of ``bench.CFG_SCALE``'s sizes, 1 225 000 users and 1 225 000 items
with 100 float features each, 41 037 500 weighted ``u-i`` and 20 212 500
weighted ``i-i`` edges (the same generator, ``np.random.default_rng(1)``,
and the same draws in the same order), on the "full" store profile, which
``outNeg`` needs for its candidate pools.  Edge seeds on ``u-i``, the
``outV()`` / ``inV()`` endpoints, two ``random`` ``outNeg`` negatives, 10
``random`` neighbours per tower (``u-i`` for users, ``i-i`` for items and
negatives), two one-layer EgoSAGEConv(mean) towers of hidden width 256 with
per-hop FeatureEncoders, the in-batch softmax loss and Adam at 1e-3.

One call runs K = ``cfg["scan_steps"]`` steps, each on ``b`` seed edge ids
drawn with ``torch.randint`` on the card; on the card they are captured in
one CUDA graph after a first eager run: ``BipartiteSteps`` is a
``bench.MultiStep``, with its side-stream warm-up, its generator
registered with the graph and its fused, capturable Adam, whose step is
the bipartite one.  The three ``*_h1`` hops are
deferred, so each tower's mean over its neighbours runs on Kernel 2
straight from the item table; the src, dst and negative rows are gathered
by Kernel 1: 3 + 3 launches a step.  ``--small`` takes the port bench's
``CFG_SMALL`` sizes (the JAX script's ``--small`` under
``GLT_BENCH_SMALL=1``) with 4 neighbours.  The ``rgcn``, ``temporal`` and
``walks`` families are not yet ported.

Usage:  python -m graph_learn_tpu_torch.examples.family_scale [--small]
            [--families bipartite] [--cpu]
Prints one line per family: <family>  <eps>M edges/s  <ms> ms/step
(warm <s>s).

Env:
  GLT_FEATURE_DTYPE    float32 | bfloat16 (default bfloat16)
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from graph_learn_tpu_torch import bench
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.store import EdgeTable, NodeTable
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.examples.bipartite_sage import towers, tower_loss
from graph_learn_tpu_torch.examples.scale_demo import nbytes
from graph_learn_tpu_torch.graph import Graph
from graph_learn_tpu_torch.gsl.compile import Query
from graph_learn_tpu_torch.gsl.dataset import Dataset
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

FAMILIES = ("rgcn", "bipartite", "temporal", "walks")
EDGE_TYPES = ("u-i", "i-i")


def build_graph(cfg: dict, device: DeviceLike = "cuda"
                ) -> Tuple[Graph, Decoder, Decoder]:
    """``run_bipartite:182-204``'s store: "u" and "i" with
    ``cfg["feat_dim"]`` float features, 67% of ``n_nodes * avg_degree``
    weighted edges "u-i", the rest "i-i", uniformly random."""
    rng = np.random.default_rng(1)
    n_u = n_i = cfg["n_nodes"] // 2
    d = cfg["feat_dim"]
    udec = Decoder(attr_types=["float"] * d)
    idec = Decoder(attr_types=["float"] * d)
    g = Graph(device=device)
    for name, dec, n_ in (("u", udec, n_u), ("i", idec, n_i)):
        g.add_node_table(NodeTable(
            name, dec, np.arange(n_, dtype=np.int64),
            float_attrs=rng.standard_normal((n_, d), np.float32)))
    e_ui = int(cfg["n_nodes"] * cfg["avg_degree"] * 0.67)
    e_ii = cfg["n_nodes"] * cfg["avg_degree"] - e_ui
    g.add_edge_table(EdgeTable(
        "u-i", "u", "i", Decoder(weighted=True),
        src=rng.integers(0, n_u, e_ui), dst=rng.integers(0, n_i, e_ui),
        num_src_nodes=n_u, num_dst_nodes=n_i,
        weights=rng.random(e_ui).astype(np.float32)))
    g.add_edge_table(EdgeTable(
        "i-i", "i", "i", Decoder(weighted=True),
        src=rng.integers(0, n_i, e_ii), dst=rng.integers(0, n_i, e_ii),
        num_src_nodes=n_i, num_dst_nodes=n_i,
        weights=rng.random(e_ii).astype(np.float32)))
    return g, udec, idec


def build_query(g: Graph, b: int, k1: int, n_neg: int) -> Query:
    """``run_bipartite:208-216``'s query."""
    seed = g.E("u-i").batch(b).alias("seed")
    src = seed.outV().alias("src")
    dst = seed.inV().alias("dst")
    neg = src.outNeg("u-i").sample(n_neg).by("random").alias("neg")
    src.outV("u-i").sample(k1).by("random").alias("src_h1")
    dst.outV("i-i").sample(k1).by("random").alias("dst_h1")
    neg.outV("i-i").sample(k1).by("random").alias("neg_h1")
    return seed.values()


def fanout(small: bool) -> Tuple[int, int]:
    """(k1, n_neg): 10 neighbours and 2 negatives, 4 and 2 when small."""
    return (4, 2) if small else (10, 2)


class BipartiteSteps(bench.MultiStep):
    """K bipartite sample+train steps a call (see the module docstring):
    ``bench.MultiStep`` with groups of one step whose seeds are ``u-i``
    edge ids and whose loss is the two towers' on the deferred egos."""

    def __init__(self, q: Query, tables, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, cfg: dict,
                 generator: torch.Generator, capture: bool):
        super().__init__(q, tables, model, optimizer, cfg, 1, generator,
                         capture)
        self.n_edges = q.source_space()[0]
        self.table = tables["nodes"]["i"].float_attrs

    def _group(self, first: int):
        with torch.no_grad():
            seeds, batch = bench.sample_one(self.q, self.tables, self.n_edges,
                                            self.generator)
        self.seeds.append(seeds)
        loss = tower_loss(self.model, batch, self.table)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.losses[first].copy_(loss.detach())


def run_bipartite(cfg: dict, small: bool = False, device: DeviceLike = "cuda",
                  capture: Optional[bool] = None,
                  graph: Optional[Tuple[Graph, Decoder, Decoder]] = None,
                  seed: int = 0) -> Dict[str, object]:
    """Build the store (or take ``graph``, a :func:`build_graph` result on
    the same device), put the plan's tables on the device, check the first
    batch through a ``Dataset``, build the towers, make one warm-up call,
    then time ``cfg["steps"] // K`` calls closed by one pull of the loss.
    ``capture`` defaults to True on the card.

    Returns edges/s (``b * (2 k1 + n_neg (1 + k1)) * K * rounds / dt``),
    the step wall in ms, the warm-up call's seconds, the host draw, CSR and
    pool build and upload seconds, the tables' bytes, capture seconds and
    graph-pool bytes (None when eager), every step's loss, and under
    "graph", "query", "tables", "model", "optimizer", "generator" and
    "step" what it built."""
    dev = resolve_device(device)
    if capture is None:
        capture = dev.type == "cuda"
    k1, n_neg = fanout(small)
    b, K = cfg["batch"], cfg["scan_steps"]
    out: Dict[str, object] = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"), "capture": capture, "K": K,
        "edges_per_step": b * (2 * k1 + n_neg * (1 + k1))}
    t0 = time.perf_counter()
    if graph is None:
        graph = build_graph(cfg, dev)
    g, udec, idec = graph
    out["host_draw_s"] = time.perf_counter() - t0
    q = build_query(g, b, k1, n_neg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ets = [g.store.edge_table(t) for t in EDGE_TYPES]
    for et in ets:
        et.host_build_s = 0.0  # stays 0 where the view is already built
    t0 = time.perf_counter()
    tables = q.device_tables(dev)
    bench._sync(dev)
    out["tables_s"] = time.perf_counter() - t0
    # the host's CSR and pool build, and the rest of it: the upload
    out["csr_build_s"] = sum(et.host_build_s for et in ets)
    out["upload_s"] = out["tables_s"] - out["csr_build_s"]
    out["tables_bytes"] = nbytes(tables)

    model = towers(udec, idec, cfg["feat_dim"], cfg["hidden"], dev)
    b0 = Dataset(q, window=1, seed=seed, device=dev).next()
    with torch.no_grad():
        loss0 = tower_loss(model, b0, tables["nodes"]["i"].float_attrs)
    if b0["neg_h1"].ids.shape != (b, n_neg, k1) or not bool(
            torch.isfinite(loss0)):
        raise RuntimeError("first batch: neg_h1 %s, loss %s"
                           % (tuple(b0["neg_h1"].ids.shape), loss0))
    optimizer = bench.make_optimizer(model, dev)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    step = BipartiteSteps(q, tables, model, optimizer, cfg, generator,
                          capture)
    t0 = time.perf_counter()
    step()
    losses = [step.losses.clone()]
    float(step.losses[-1])
    out["warm_s"] = time.perf_counter() - t0
    rounds = max(cfg["steps"] // K, 1)
    t0 = time.perf_counter()
    for _ in range(rounds):
        step()
        losses.append(step.losses.clone())
    float(step.losses[-1])  # the one pull: a true barrier
    dt = time.perf_counter() - t0
    out.update(rounds=rounds,
               edges_per_s=out["edges_per_step"] * K * rounds / dt,
               step_ms=dt / (K * rounds) * 1e3,
               losses=torch.cat(losses).tolist(),
               capture_s=step.capture_s, graph_pool_bytes=step.pool_bytes)
    if dev.type == "cuda":
        out["device_bytes_peak"] = torch.cuda.max_memory_allocated(dev)
    out.update(graph=graph, query=q, tables=tables, model=model,
               optimizer=optimizer, generator=generator, step=step)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--families", default="bipartite")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    families = args.families.split(",")
    for fam in families:
        if fam not in FAMILIES:
            raise InvalidArgumentError("unknown family %r" % fam)
        if fam != "bipartite":
            raise InvalidArgumentError("family %r is not yet ported" % fam)
    cfg = bench.CFG_SMALL if args.small else bench.CFG_SCALE
    dtype = os.environ.get("GLT_FEATURE_DTYPE", "bfloat16")
    for fam in families:
        with bench.bench_conf(feature_dtype=dtype, storage_profile="full"):
            r = run_bipartite(cfg, args.small, dev)
        print("%-10s %.1fM edges/s  %.2f ms/step  (warm %.1fs)"
              % (fam, r["edges_per_s"] / 1e6, r["step_ms"], r["warm_s"]),
              flush=True)
    return 0


if __name__ == "__main__":
    main()
