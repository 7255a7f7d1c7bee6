"""Scale demonstration: training on an ogbn-products-size graph on one card.

Counterpart of ``examples/scale_demo.py``: 2.45M nodes, 62M directed edges
(ogbn-products has 2.45M nodes / 61.9M undirected edges), 100 float
features, 47 classes, EgoGraphSAGE fanout [15, 10], the store resident on
the card under ``conf.storage_profile = "minimal"`` with a bf16 feature
table.  The JAX script scans K steps inside one jitted function; here a
step is a plain eager sequence, every step of it on the card:

    seeds drawn on the device -> GSL plan (``_execute``)
    -> ``pre_aggregate_hop`` (deepest-hop mean, outside the gradient)
    -> loss -> backward -> Adam

and the losses are pulled once, after the last step.

Usage:  python -m graph_learn_tpu_torch.examples.scale_demo
            [--small] [--steps N] [--cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.store import EdgeTable, NodeTable
from graph_learn_tpu_torch.graph import Graph
from graph_learn_tpu_torch.gsl.compile import Query, _execute
from graph_learn_tpu_torch.gsl.dataset import Dataset
from graph_learn_tpu_torch.nn.data import EgoGraph, pre_aggregate_hop
from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

HOPS = ["hop1", "hop2"]
HIDDEN = 256
LEARNING_RATE = 1e-3
PUBLISHED = dict(n_nodes=2_450_000, n_edges=62_000_000, feat_dim=100,
                 classes=47, batch=1024, fanout=(15, 10))
SMALL = dict(n_nodes=2_000, n_edges=20_000, feat_dim=12, classes=5, batch=64,
             fanout=(5, 3))


@contextlib.contextmanager
def frontier_conf():
    """The store as the 62M-edge frontier keeps it: only the forward CSR
    and a bf16 feature table on the device."""
    old = conf.storage_profile, conf.feature_dtype
    conf.storage_profile, conf.feature_dtype = "minimal", "bfloat16"
    try:
        yield
    finally:
        conf.storage_profile, conf.feature_dtype = old


def build_graph(n_nodes: int, n_edges: int, feat_dim: int, classes: int,
                device: DeviceLike = "cuda",
                seed: int = 0) -> Tuple[Graph, Decoder]:
    """One "item" node type with features and labels and one unweighted
    "rel" edge type, drawn as ``examples/scale_demo.py:39-51`` draws them
    (same generator, same order)."""
    rng = np.random.default_rng(seed)
    dec = Decoder(labeled=True, attr_types=["float"] * feat_dim)
    g = Graph(device=device)
    g.add_node_table(NodeTable(
        "item", dec, np.arange(n_nodes, dtype=np.int64),
        float_attrs=rng.standard_normal((n_nodes, feat_dim)).astype(
            np.float32),
        labels=rng.integers(0, classes, n_nodes).astype(np.int32)))
    g.add_edge_table(EdgeTable(
        "rel", "item", "item", Decoder(),
        src=rng.integers(0, n_nodes, n_edges),
        dst=rng.integers(0, n_nodes, n_edges),
        num_src_nodes=n_nodes, num_dst_nodes=n_nodes))
    return g, dec


def two_hop_query(g: Graph, batch: int, fanout: Sequence[int]) -> Query:
    k1, k2 = fanout
    return (g.V("item").batch(batch).alias("src")
            .outV("rel").sample(k1).by("random").alias("hop1")
            .outV("rel").sample(k2).by("random").alias("hop2").values())


def sample_batch(q: Query, tables, seeds: torch.Tensor,
                 generator: torch.Generator) -> dict:
    """The plan's batch with the deepest hop reduced to its group means,
    outside any gradient: its [b * k1 * k2, D] rows are never gathered."""
    with torch.no_grad():
        batch = _execute(q, tables, seeds, generator)
        return pre_aggregate_hop(batch, "hop2",
                                 tables["nodes"]["item"].float_attrs, "mean")


def loss_of(model, batch: dict, generator=None) -> torch.Tensor:
    ego = EgoGraph.from_query_result(batch, "src", HOPS)
    logits = model(ego, training=True, generator=generator)
    return supervised_softmax_loss(logits, batch["src"].labels)


def train_steps(q: Query, tables, model, optimizer, steps: int, n_nodes: int,
                generator: torch.Generator) -> torch.Tensor:
    """``steps`` training steps with seeds drawn on the device; returns the
    losses [steps], still on the device."""
    dev = next(model.parameters()).device
    b = q.dag.batch_size
    losses = []
    for _ in range(steps):
        seeds = torch.randint(0, n_nodes, (b,), generator=generator,
                              device=dev, dtype=torch.int32)
        loss = loss_of(model, sample_batch(q, tables, seeds, generator),
                       generator)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    return torch.stack(losses) if losses else torch.zeros(0, device=dev)


def nbytes(x) -> int:
    """Bytes of every tensor in a (nested) dict or struct of tables."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(nbytes(v) for v in x.values())
    if dataclasses.is_dataclass(x):
        return sum(nbytes(getattr(x, f.name)) for f in dataclasses.fields(x))
    return 0


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(n_nodes: int = PUBLISHED["n_nodes"],
        n_edges: int = PUBLISHED["n_edges"],
        feat_dim: int = PUBLISHED["feat_dim"],
        classes: int = PUBLISHED["classes"], batch: int = PUBLISHED["batch"],
        fanout: Sequence[int] = PUBLISHED["fanout"], steps: int = 30,
        device: DeviceLike = "cuda", warmup: int = 3, seed: int = 0,
        graph: Optional[Tuple[Graph, Decoder]] = None) -> Dict[str, object]:
    """Build the graph (or take ``graph``, a :func:`build_graph` result on
    the same device, built under :func:`frontier_conf`), put its tables on
    the device, take the first batch from a ``Dataset`` and train ``warmup
    + steps`` steps.  Returns the numbers (times on the host clock, ended
    by a synchronize) and, under "graph", "query" and "model", what it
    built."""
    dev = resolve_device(device)
    k1, k2 = fanout
    out: Dict[str, object] = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "n_nodes": n_nodes, "n_edges": n_edges, "steps": steps}
    with frontier_conf():
        t0 = time.perf_counter()
        if graph is None:
            graph = build_graph(n_nodes, n_edges, feat_dim, classes, dev,
                                seed)
        g, dec = graph
        out["host_build_s"] = time.perf_counter() - t0
        q = two_hop_query(g, batch, fanout)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        tables = q.device_tables(dev)
        _sync(dev)
        out["tables_s"] = time.perf_counter() - t0
        out["tables_bytes"] = nbytes(tables)

        model = EgoGraphSAGE([feat_dim, HIDDEN, classes], dec,
                             agg_type="gcn", device=dev)
        optimizer = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
        # the first batch through the Dataset, as a user's loop takes it
        b0 = Dataset(q, window=1, seed=seed, device=dev).next()
        with torch.no_grad():
            logits0 = model(EgoGraph.from_query_result(
                b0, "src", HOPS,
                defer_last_table=tables["nodes"]["item"].float_attrs))
        if tuple(logits0.shape) != (batch, classes):
            raise RuntimeError("first batch: logits %s" % (logits0.shape,))

        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        warm = train_steps(q, tables, model, optimizer, warmup, n_nodes, gen)
        _sync(dev)
        t0 = time.perf_counter()
        losses = train_steps(q, tables, model, optimizer, steps, n_nodes, gen)
        losses = torch.cat([warm, losses]).cpu()  # the one pull
        _sync(dev)
        wall = time.perf_counter() - t0
    out["losses"] = losses.tolist()
    out["step_ms"] = wall / max(steps, 1) * 1e3
    out["edges_per_s"] = batch * (k1 + k1 * k2) * steps / max(wall, 1e-12)
    if dev.type == "cuda":
        out["device_bytes_peak"] = torch.cuda.max_memory_allocated(dev)
    out.update(graph=graph, query=q, model=model)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="a 2 000-node graph (with --cpu: no card needed)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    size = SMALL if args.small else PUBLISHED
    print("building %d-node, %d-edge graph on the host..."
          % (size["n_nodes"], size["n_edges"]), flush=True)
    r = run(steps=args.steps, device="cpu" if args.cpu else "cuda", **size)
    print("host build %.1f s, tables on the device %.1f s (%.2f GB%s)"
          % (r["host_build_s"], r["tables_s"], r["tables_bytes"] / 1e9,
             ", peak %.2f GB allocated" % (r["device_bytes_peak"] / 1e9)
             if "device_bytes_peak" in r else ""))
    print("scale demo on %s: %.2f ms/step on the host clock, %.2fM edges/s "
          "on a %d-edge graph; loss %.4f -> %.4f over %d steps"
          % (r["device"], r["step_ms"], r["edges_per_s"] / 1e6,
             r["n_edges"], r["losses"][0], r["losses"][-1],
             len(r["losses"])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
