"""EgoRGCN supervised over two relations, trained through LocalTrainer.

Counterpart of ``examples/ego_rgcn_supervised.py``: ``rgcn_query:25-39``
(the hop tree expanded per relation at each level: level l has R^l groups,
aliases ``r0_h1, r1_h1, r0_r0_h2, r0_r1_h2, r1_r0_h2, r1_r1_h2`` for two
relations and two levels) and ``make_ego:42-44``, then ``EgoRGCN`` with
basis (or block) decomposition, the softmax cross-entropy and Adam through
``LocalTrainer.train``, and the test accuracy through
``LocalTrainer.evaluate``.  The JAX example loads its Cora-like TSV files
through ``graph.node()`` / ``init()``, as the port's
``examples/ego_rgcn_supervised.py`` does; the store here is built in
memory instead, by :func:`build_rgcn_graph`: the two-relation store of
``examples/family_scale.py run_rgcn:69-88`` (the same generator,
``np.random.default_rng(0)``, and the same draws in the same order), with
its relations named ``rel0`` and ``rel1`` as there, and the first 80% of
the items as the train split, the rest as the test split.

The port's lookups leave feature rows deferred (``core/values.py``);
:func:`make_ego` gathers every hop's rows (Kernel 1 on the card), as the
JAX batch arrives, so ``EgoRGCN`` takes its materialised route.  Hops
already reduced to ``PreAggregatedRows`` (:func:`pre_aggregate_deepest`)
stay as they are and take its deferred route (Kernel 2).

Usage:  python -m graph_learn_tpu_torch.examples.ego_rgcn [--cpu]
            [--epochs N] [--steps_per_epoch S] [--num_bases B]
            [--num_blocks NB]
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from graph_learn_tpu_torch.core.schema import Decoder, Mask
from graph_learn_tpu_torch.core.store import EdgeTable, NodeTable
from graph_learn_tpu_torch.graph import Graph
from graph_learn_tpu_torch.gsl.compile import Query
from graph_learn_tpu_torch.nn.data import (EgoGraph, materialized,
                                           pre_aggregate_hop)
from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoRGCN
from graph_learn_tpu_torch.nn.trainer import LocalTrainer
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

RELS = ("rel0", "rel1")


def build_rgcn_graph(cfg: dict, device: DeviceLike = "cuda"
                     ) -> Tuple[Graph, Decoder]:
    """``run_rgcn:69-88``'s store: ``cfg["n_nodes"]`` "item" nodes with
    ``cfg["feat_dim"]`` float features and labels in [0,
    ``cfg["classes"]``), and two weighted item -> item relations of
    ``n_nodes * avg_degree // 2`` uniformly random edges each."""
    rng = np.random.default_rng(0)
    n, d = cfg["n_nodes"], cfg["feat_dim"]
    dec = Decoder(labeled=True, attr_types=["float"] * d)
    g = Graph(device=device)
    g.add_node_table(NodeTable(
        "item", dec, np.arange(n, dtype=np.int64),
        float_attrs=rng.standard_normal((n, d), np.float32),
        labels=rng.integers(0, cfg["classes"], n).astype(np.int32)))
    e_half = n * cfg["avg_degree"] // 2
    for rel in RELS:
        src = rng.integers(0, n, e_half)
        dst = rng.integers(0, n, e_half)
        g.add_edge_table(EdgeTable(
            rel, "item", "item", Decoder(weighted=True), src=src, dst=dst,
            num_src_nodes=n, num_dst_nodes=n,
            weights=rng.random(e_half).astype(np.float32)))
    return g, dec


def rgcn_query(g: Graph, mask, batch_size: int, nbrs: Sequence[int],
               rels: Sequence[str] = RELS) -> Tuple[Query, List[str]]:
    """The hop tree: at level l every group of level l - 1 samples
    ``nbrs[l - 1]`` ``random`` neighbours over each relation of ``rels``
    (the TSV form's are ``relation`` and ``relation2``)."""
    src = g.V("item", mask=mask).batch(batch_size).alias("src")
    aliases: List[str] = []
    frontier = [("", src)]
    for level, k in enumerate(nbrs):
        nxt = []
        for prefix, node in frontier:
            for r, rel in enumerate(rels):
                alias = "%sr%d_h%d" % (prefix, r, level + 1)
                hop = node.outV(rel).sample(k).by("random").alias(alias)
                aliases.append(alias)
                nxt.append(("%sr%d_" % (prefix, r), hop))
        frontier = nxt
    return src.values(), aliases


def make_ego(batch: dict, aliases: Sequence[str],
             nbrs: Sequence[int]) -> EgoGraph:
    """The EgoGraph of a batch, every hop's deferred rows gathered."""
    return EgoGraph(src=materialized(batch["src"]),
                    hops=[materialized(batch[a]) for a in aliases],
                    nbr_nums=tuple(nbrs))


def pre_aggregate_deepest(batch: dict, aliases: Sequence[str],
                          table: torch.Tensor, n_deep: int,
                          op: str = "mean") -> dict:
    """``batch`` with its ``n_deep`` deepest hops (the last aliases)
    reduced over their fanout into ``PreAggregatedRows`` (Kernel 2 each),
    so that the raw rows never enter the gradient."""
    for a in aliases[-n_deep:]:
        batch = pre_aggregate_hop(batch, a, table, op=op)
    return batch


def rgcn_loss(model: EgoRGCN, batch: dict, aliases: Sequence[str],
              nbrs: Sequence[int], training: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    logits = model(make_ego(batch, aliases, nbrs), training=training,
                   generator=generator)
    return supervised_softmax_loss(logits, batch["src"].labels)


def split(g: Graph, train_share: float = 0.8) -> Graph:
    """The first ``train_share`` of the items as the train split, the rest
    as the test split."""
    raw = g.store.node_table("item").raw_ids
    cut = int(raw.size * train_share)
    g.add_node_set("item", raw[:cut], Mask.TRAIN)
    g.add_node_set("item", raw[cut:], Mask.TEST)
    return g


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_nodes", type=int, default=5_000)
    ap.add_argument("--avg_degree", type=int, default=10)
    ap.add_argument("--features_num", type=int, default=64)
    ap.add_argument("--classes", type=int, default=7)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--steps_per_epoch", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--nbrs", type=int, nargs="+", default=[10, 5])
    ap.add_argument("--num_bases", type=int, default=1)
    ap.add_argument("--num_blocks", type=int, default=0)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")

    cfg = dict(n_nodes=args.n_nodes, avg_degree=args.avg_degree,
               feat_dim=args.features_num, classes=args.classes)
    g, dec = build_rgcn_graph(cfg, dev)
    split(g)
    model = EgoRGCN([args.features_num, args.hidden, args.classes], dec,
                    num_relations=len(RELS),
                    num_bases=args.num_bases or None,
                    num_blocks=args.num_blocks or None, device=dev)
    train_q, aliases = rgcn_query(g, Mask.TRAIN, args.batch_size, args.nbrs)
    test_q, _ = rgcn_query(g, Mask.TEST, args.batch_size, args.nbrs)

    def loss_fn(m, batch, generator, training):
        return rgcn_loss(m, batch, aliases, args.nbrs, training, generator)

    def acc_fn(m, batch):
        logits = m(make_ego(batch, aliases, args.nbrs), training=False)
        return (logits.argmax(1) == batch["src"].labels.long()).float()

    tr = LocalTrainer(device=dev)
    tr.train(train_q, model, loss_fn,
             torch.optim.Adam(model.parameters(), lr=args.lr),
             epochs=args.epochs, steps_per_epoch=args.steps_per_epoch)
    acc = tr.evaluate(test_q, model, acc_fn)
    print("test accuracy: %.4f" % acc)
    return acc


if __name__ == "__main__":
    main()
