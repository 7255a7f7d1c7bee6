"""A dry run of one sharded training step on a mesh of ranks.

The port's analogue of ``__graft_entry__.py:97 dryrun_multichip``:
:func:`dryrun_multichip` starts ``n_ranks`` ranks (``parallel/launch.py``)
and each builds the same toy flagship (a Cora-like store of 256 nodes
with 16 features written by ``examples/data/synthetic.py cora_like``, the
2-hop EgoGraphSAGE query of fan-out [4, 2] over the train split, hidden
16, 7 classes), then takes on a mesh of ``n_graph = 2`` graph ranks where
that divides ``n_ranks`` (else 1):

1. one data-parallel step over tables placed by ``shard_tables`` (node
   payloads sharded over the graph axis, the CSR whole);
2. one step over the range-partitioned store (each rank holds its block;
   owner-routed feature rows).

Each rank returns its losses, the bytes of its block against the whole
store's and the bytes its graph-axis collectives moved; every loss must
be finite and the block smaller than the store.

    python -m graph_learn_tpu_torch.parallel.dryrun --ranks 2 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List, Optional

import torch


def _rank(rank: int, world: int, seed: int) -> dict:
    import graph_learn_tpu_torch as glt
    from graph_learn_tpu_torch.core.sharding import COLLECTIVES, GRAPH_AXIS
    from graph_learn_tpu_torch.examples.data.synthetic import cora_like
    from graph_learn_tpu_torch.examples.scale_demo import nbytes
    from graph_learn_tpu_torch.nn.data import EgoGraph
    from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
    from graph_learn_tpu_torch.parallel import bootstrap
    from graph_learn_tpu_torch.parallel.mesh import make_mesh, shard_tables
    from graph_learn_tpu_torch.parallel.sharded_store import (
        build_sharded_tables)
    from graph_learn_tpu_torch.parallel.train import (
        make_partitioned_train_step, make_sharded_train_step)

    dev = bootstrap.current_device()
    n_graph = 2 if world % 2 == 0 and world > 1 else 1
    n_data = world // n_graph
    mesh = make_mesh(n_data, n_graph)
    with tempfile.TemporaryDirectory(prefix="glt_dryrun_") as d:
        cora_like(d, n=256, classes=7, feat_dim=16, avg_degree=6, seed=seed)
        dec = glt.Decoder(labeled=True, attr_types=["float"] * 16)
        g = (glt.Graph(device=dev)
             .node(os.path.join(d, "node_table"), "item", dec)
             .edge(os.path.join(d, "edge_table"), ("item", "item", "rel"),
                   glt.Decoder(weighted=True), directed=False)
             .node(os.path.join(d, "train_table"), "item",
                   glt.Decoder(weighted=True), mask=glt.Mask.TRAIN)).init()
    hops = ["hop1", "hop2"]
    q = (g.V("item", mask=glt.Mask.TRAIN).batch(4 * n_data).alias("src")
         .outV("rel").sample(4).by("random").alias("hop1")
         .outV("rel").sample(2).by("random").alias("hop2").values())

    def loss_fn(model, batch, gen, training):
        ego = EgoGraph.from_query_result(batch, "src", hops)
        return supervised_softmax_loss(
            model(ego, training=training, generator=gen),
            batch["src"].labels)

    seeds = torch.as_tensor(q.seed_indices()[:4 * n_data], device=dev)
    out = {"mesh": (n_data, n_graph)}
    for name in ("replicated", "partitioned"):
        torch.manual_seed(seed)
        model = EgoGraphSAGE([16, 16, 7], dec, agg_type="gcn", device=dev)
        opt = torch.optim.Adam(model.parameters(), lr=0.05)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        COLLECTIVES.reset()
        if name == "replicated":
            tables = shard_tables(q.device_tables(dev), mesh)
            step = make_sharded_train_step(q, model, loss_fn, opt, mesh)
            loss = step(tables, seeds, gen)
        else:
            st = build_sharded_tables(q, n_graph, shard=rank % n_graph)
            st = st.place(mesh, device=dev)
            step = make_partitioned_train_step(q, model, loss_fn, opt, mesh,
                                               st)
            loss = step(seeds, gen)
            out["block_bytes"] = st.device_bytes()
            out["store_bytes"] = nbytes(q.device_tables(dev))
        out[name + "_loss"] = float(loss)
        out[name + "_graph_axis_bytes"] = COLLECTIVES.total_bytes(GRAPH_AXIS)
    return out


def dryrun_multichip(n_ranks: int, device: str = "cuda",
                     backend: Optional[str] = None, seed: int = 0,
                     timeout_s: float = 300.0) -> List[dict]:
    """One sharded step on ``n_ranks`` ranks of ``device`` (ranks that
    share a card need ``backend="gloo"``); returns each rank's record
    and raises if a loss is not finite or a block is not smaller than
    the store."""
    from graph_learn_tpu_torch.parallel.launch import spawn
    out = spawn(_rank, n_ranks, device=device, backend=backend, args=(seed,),
                timeout_s=timeout_s,
                threads=1 if device == "cpu" else None)
    for r in out:
        for k in ("replicated_loss", "partitioned_loss"):
            if not torch.isfinite(torch.tensor(r[k])):
                raise RuntimeError("dryrun: %s is %r" % (k, r[k]))
        if r["mesh"][1] > 1 and not r["block_bytes"] < r["store_bytes"]:
            raise RuntimeError("dryrun: a block of %d bytes for a store of %d"
                               % (r["block_bytes"], r["store_bytes"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    for r in dryrun_multichip(args.ranks, args.device, args.backend):
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
