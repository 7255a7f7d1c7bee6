"""Unsupervised SubGraph-mode GraphSAGE over edge-induced enclosing stars.

Counterpart of ``examples/sage_unsupervised.py``: ``E("train")`` edge
seeds on the undirected train edge type, a ``full`` 1-hop of each end
and of one ``random`` negative dst (``build_query:43-52``), a star
subgraph per edge (``BatchGraph.from_edge_star``, ``induce:55-63``: one
for the positive pair, one for the negative), a ``GraphSAGE`` over the
batched ``edge_index``, the dot product of the two anchors as the score,
the sigmoid cross-entropy and Adam at 5e-4 through ``LocalTrainer``;
then the link accuracy (pos > neg) over one epoch.  Each BatchGraph
gathers its node rows once (Kernel 1): two launches a step.

As the JAX example's ``load`` does, :func:`load` reads
``examples/data/synthetic.py cora_like``'s 800-node TSV files (written
first when ``--data_dir`` has none; features to five decimals) through
``Graph.node/edge/init``: node type "i", the undirected weighted
``train`` edges.  :func:`build_graph` builds the same store in memory
from the draws (``node2vec.cora_like``); given the features as their
text reads back (``text=True``) it is the files' store bit for bit.
The JAX example spells its flags with dashes (``--data-dir``); the
port's, with underscores, as its other examples do.

Usage:  python -m graph_learn_tpu_torch.examples.sage_unsupervised [--cpu]
            [--data_dir D] [--batch_size B] [--epochs N] [--steps_per_epoch S]
            [--feat_dim D] [--hidden H] [--out_dim O] [--nbrs_num K]
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.store import EdgeTable, NodeTable
from graph_learn_tpu_torch.examples import node2vec
from graph_learn_tpu_torch.graph import Graph
from graph_learn_tpu_torch.gsl.compile import Query
from graph_learn_tpu_torch.nn.data import materialized
from graph_learn_tpu_torch.nn.feature_column import FeatureEncoder
from graph_learn_tpu_torch.nn.loss import sigmoid_cross_entropy_loss
from graph_learn_tpu_torch.nn.models.sub_models import GraphSAGE
from graph_learn_tpu_torch.nn.subgraph_data import BatchGraph
from graph_learn_tpu_torch.nn.trainer import LocalTrainer
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device


DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "glt_sage_unsup")
NODES = 800


def load(data_dir: str, feat_dim: int, device: DeviceLike = "cuda"
         ) -> Tuple[Graph, Decoder]:
    """(graph, node decoder) from ``cora_like(n=800)``'s files in
    ``data_dir`` (written first if they are missing), as the JAX
    example's ``load:32-40`` reads them."""
    return node2vec.load(data_dir, feat_dim, NODES, edge_type="train",
                         node_type="i", device=device)


def build_graph(a: Dict[str, np.ndarray], device: DeviceLike = "cuda"
                ) -> Tuple[Graph, Decoder]:
    """Node type "i" (labels, float features) and the undirected, weighted
    ``train`` edges, as the JAX example's ``load`` reads them."""
    n, d = a["feats"].shape
    dec = Decoder(labeled=True, attr_types=["float"] * d)
    g = Graph(device=device)
    g.add_node_table(NodeTable("i", dec, np.arange(n, dtype=np.int64),
                               float_attrs=a["feats"], labels=a["labels"]))
    g.add_edge_table(EdgeTable(
        "train", "i", "i", Decoder(weighted=True), src=a["src"],
        dst=a["dst"], num_src_nodes=n, num_dst_nodes=n,
        weights=np.ones(a["src"].size, np.float32)), directed=False)
    return g, dec


def build_query(g: Graph, batch_size: int, nbrs_num: int) -> Query:
    """A ``full`` 1-hop of each end of a train edge and of one random
    negative (``build_query:43-52``)."""
    seed = g.E("train").batch(batch_size).shuffle(traverse=True) \
        .alias("seed")
    src = seed.outV().alias("pos_src")
    src.outV("train").sample(nbrs_num).by("full").alias("src_hop1")
    dst = seed.inV().alias("pos_dst")
    dst.outV("train").sample(nbrs_num).by("full").alias("dst_hop1")
    neg = src.outNeg("train").sample(1).by("random").alias("neg_dst")
    neg.outV("train").sample(nbrs_num).by("full").alias("neg_hop1")
    return seed.values()


def induce(batch: dict) -> Tuple[BatchGraph, BatchGraph]:
    """The positive and the negative edge stars of a batch."""
    pos = BatchGraph.from_edge_star(batch["pos_src"], batch["pos_dst"],
                                    batch["src_hop1"], batch["dst_hop1"])
    neg = BatchGraph.from_edge_star(batch["pos_src"], batch["neg_dst"],
                                    batch["src_hop1"], batch["neg_hop1"])
    return pos, neg


class SageLink(nn.Module):
    """``enc`` (a FeatureEncoder) and ``sage`` (GraphSAGE ``[feat_dim,
    hidden * (depth - 1), out_dim]``); a pair's score is the dot product
    of its two anchors' embeddings."""

    def __init__(self, dec: Decoder, feat_dim: int, hidden: int,
                 out_dim: int, depth: int = 2, agg_type: str = "mean",
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.enc = FeatureEncoder(dec).to(dev)
        dims = [feat_dim] + [hidden] * (depth - 1) + [out_dim]
        self.sage = GraphSAGE(dims, agg_type=agg_type, device=dev,
                              generator=generator)

    def score(self, bg: BatchGraph) -> torch.Tensor:
        x = self.enc(materialized(bg.nodes))  # one gather a BatchGraph
        x = torch.where(bg.node_mask[:, None], x, 0.0)
        h = self.sage(bg.edge_index, x, edge_mask=bg.edge_mask)
        return (bg.anchor(h, 0) * bg.anchor(h, 1)).sum(dim=-1)

    def forward(self, pos_bg: BatchGraph, neg_bg: BatchGraph):
        return self.score(pos_bg), self.score(neg_bg)


def link_loss(model: SageLink, batch: dict, generator=None,
              training: bool = True) -> torch.Tensor:
    """``LocalTrainer``'s ``loss_fn``: the sigmoid cross-entropy of the
    positive and negative stars' scores."""
    return sigmoid_cross_entropy_loss(*model(*induce(batch)))


def link_accuracy(model: SageLink, batch: dict) -> torch.Tensor:
    """Per edge: 1 where the positive pair outscores the negative."""
    pos, neg = model(*induce(batch))
    return (pos > neg).float()


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default=DEFAULT_DIR)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--steps_per_epoch", type=int, default=30)
    ap.add_argument("--feat_dim", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--out_dim", type=int, default=32)
    ap.add_argument("--nbrs_num", type=int, default=16)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")

    g, dec = load(args.data_dir, args.feat_dim, dev)
    q = build_query(g, args.batch_size, args.nbrs_num)
    model = SageLink(dec, args.feat_dim, args.hidden, args.out_dim,
                     device=dev)
    tr = LocalTrainer(device=dev)
    tr.train(q, model, link_loss,
             torch.optim.Adam(model.parameters(), lr=5e-4),
             epochs=args.epochs, steps_per_epoch=args.steps_per_epoch)
    acc = tr.evaluate(q, model, link_accuracy)
    print("link accuracy (pos>neg): %.4f" % acc)
    return acc


if __name__ == "__main__":
    main()
