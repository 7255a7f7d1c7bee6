"""EgoTGAT temporal link prediction on a bipartite event stream.

Counterpart of ``examples/ego_tgat.py``: events are traversed with
``g.E("train")`` in order; each event builds three towers, src (a user),
dst (its item) and one ``random`` negative item, whose two hops are
recency-``topk`` temporal neighbours over ``interaction`` /
``interaction_reverse`` (only edges strictly earlier than the event,
``build_query:55-76``); ``EgoTGAT`` encodes the time spans and attends
over ``[node ++ edge ++ time]`` neighbour features (every conv's
neighbour block on Kernel 3), ``LinkScorePredict`` scores (src, dst) and
(src, neg), the sigmoid cross-entropy and Adam at 1e-3 train it through
``LocalTrainer.train``, and the test accuracy is the mean of ``pos > 0.5``
and ``neg < 0.5`` over the held-out events.

As the JAX example does, :func:`load` reads ``temporal_u2i``'s TSV files
(``examples/data/synthetic.py``; written first when ``--data_dir`` has
none, features to five decimals) through ``Graph.node/edge/init``:
``interaction`` (every event, undirected: with its
``interaction_reverse`` table), and the chronological ``train`` (first
70%) and ``test`` (last 15%) event tables.  :func:`build_graph` builds
the same store in memory from the generator's draws
(:func:`temporal_u2i`); given the draws as their text reads back
(``synthetic.as_read``) it is the TSV store bit for bit.

Usage:  python -m graph_learn_tpu_torch.examples.ego_tgat [--cpu]
            [--data_dir D] [--epochs N] [--batch_size B] [--nbrs K1 K2 ...]
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.store import EdgeTable, NodeTable
from graph_learn_tpu_torch.examples.data import synthetic
from graph_learn_tpu_torch.graph import Graph
from graph_learn_tpu_torch.gsl.compile import Query
from graph_learn_tpu_torch.nn.data import TemporalGraph
from graph_learn_tpu_torch.nn.feature_column import FeatureEncoder
from graph_learn_tpu_torch.nn.loss import sigmoid_cross_entropy_loss
from graph_learn_tpu_torch.nn.models.tgat import EgoTGAT, LinkScorePredict
from graph_learn_tpu_torch.nn.trainer import LocalTrainer
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

TOWERS = ("src", "dst", "neg")


def temporal_u2i(n_users: int = 300, n_items: int = 200,
                 n_clusters: int = 4, events: int = 6000, feat_dim: int = 8,
                 edge_feat_dim: int = 4, seed: int = 0, text: bool = False
                 ) -> Dict[str, np.ndarray]:
    """``temporal_u2i:122``'s JODIE-style event stream as arrays
    (``synthetic.temporal_u2i_arrays``), float32; with ``text`` the float
    columns as the loader reads back their five-decimal text."""
    a = synthetic.temporal_u2i_arrays(n_users, n_items, n_clusters, events,
                                      feat_dim, edge_feat_dim, seed)
    cast = synthetic.as_read if text else (lambda x: x.astype(np.float32))
    return {**a, **{k: cast(a[k]) for k in ("u_feat", "i_feat",
                                            "edge_feat")}}


def load(data_dir: str, feat_dim: int = 8, edge_feat_dim: int = 4,
         events: int = 6000, device: DeviceLike = "cuda"
         ) -> Tuple[Graph, Decoder, Decoder, Decoder]:
    """The example's store from ``temporal_u2i``'s TSV files in
    ``data_dir`` (written first if they are missing), through
    ``Graph.node/edge/init``, as the JAX example's ``load`` does."""
    if not os.path.exists(os.path.join(data_dir, "user_table")):
        synthetic.temporal_u2i(data_dir, events=events, feat_dim=feat_dim,
                               edge_feat_dim=edge_feat_dim)
    udec, idec, edec = _decoders(feat_dim, edge_feat_dim)
    g = (Graph(device=device)
         .node(os.path.join(data_dir, "user_table"), "u", udec)
         .node(os.path.join(data_dir, "item_table"), "i", idec)
         .edge(os.path.join(data_dir, "interaction_table"),
               ("u", "i", "interaction"), edec, directed=False)
         .edge(os.path.join(data_dir, "train_table"), ("u", "i", "train"),
               edec)
         .edge(os.path.join(data_dir, "test_table"), ("u", "i", "test"),
               edec))
    return g.init(), udec, idec, edec


def _decoders(d: int, e: int) -> Tuple[Decoder, Decoder, Decoder]:
    return (Decoder(attr_types=["float"] * d),
            Decoder(attr_types=["float"] * d),
            Decoder(attr_types=["float"] * e, timestamped=True))


def build_graph(a: Dict[str, np.ndarray], device: DeviceLike = "cuda"
                ) -> Tuple[Graph, Decoder, Decoder, Decoder]:
    """Node types "u" and "i"; the undirected timestamped ``interaction``
    (all events) with ``interaction_reverse``, and the ``train`` (first
    70%) and ``test`` (last 15%) events, as the JAX example loads them."""
    n_u, d = a["u_feat"].shape
    n_i = a["i_feat"].shape[0]
    n = a["src"].size
    udec, idec, edec = _decoders(d, a["edge_feat"].shape[1])
    g = Graph(device=device)
    g.add_node_table(NodeTable("u", udec, np.arange(n_u, dtype=np.int64),
                               float_attrs=a["u_feat"]))
    g.add_node_table(NodeTable("i", idec, np.arange(n_i, dtype=np.int64),
                               float_attrs=a["i_feat"]))
    n_tr, n_va = int(n * 0.7), int(n * 0.85)
    for name, rows in (("interaction", slice(0, n)),
                       ("train", slice(0, n_tr)), ("test", slice(n_va, n))):
        g.add_edge_table(EdgeTable(
            name, "u", "i", edec, src=a["src"][rows], dst=a["dst"][rows],
            num_src_nodes=n_u, num_dst_nodes=n_i, timestamps=a["ts"][rows],
            float_attrs=a["edge_feat"][rows]))
        if name == "interaction":
            g.add_reverse_edge_table("interaction")
    return g, udec, idec, edec


def build_query(g: Graph, batch_size: int, nbrs: Sequence[int],
                etype: str = "train") -> Query:
    """Event query with temporal ``topk`` hops per tower
    (``build_query:55-76``): src (u) hops over interaction ->
    interaction_reverse, dst and neg (i) over interaction_reverse ->
    interaction."""
    events = g.E(etype).batch(batch_size).alias("event")
    src = events.outV().alias("src")
    dst = events.inV().alias("dst")
    neg = src.outNeg("interaction").sample(1).by("random").alias("neg")

    def hops(v, name, etypes):
        cur = v
        for i, (k, et) in enumerate(zip(nbrs, etypes)):
            e = cur.outE(et).sample(k).by("topk") \
                .alias("%s_nbr_%d" % (name, i + 1))
            cur = e.inV().alias("%s_nbr_node_%d" % (name, i + 1))

    hops(src, "src", ["interaction", "interaction_reverse"])
    hops(dst, "dst", ["interaction_reverse", "interaction"])
    hops(neg, "neg", ["interaction_reverse", "interaction"])
    return events.values()


def tower(result: dict, name: str, nhops: int) -> TemporalGraph:
    """The ``name`` tower's TemporalGraph (every feature row gathered)."""
    return TemporalGraph.from_query_result(
        result, name,
        ["%s_nbr_%d" % (name, i + 1) for i in range(nhops)],
        ["%s_nbr_node_%d" % (name, i + 1) for i in range(nhops)],
        "event")


class TGATLink(nn.Module):
    """Three towers and the affinity scorer (the item tower is shared by
    dst and neg): ``u_tower`` over u, i, u, ...; ``i_tower`` over i, u, i,
    ...; ``scorer``.  Weights are drawn from ``generator`` (default: seeded
    with 0) in the order u_tower, i_tower, scorer."""

    def __init__(self, udec: Decoder, idec: Decoder, hidden: int,
                 out_dim: int, time_dim: int, nhops: int, edge_dim: int,
                 num_head: int = 2, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.u_enc = FeatureEncoder(udec)
        self.i_enc = FeatureEncoder(idec)
        alt_u = [self.u_enc if i % 2 == 0 else self.i_enc
                 for i in range(nhops + 1)]
        alt_i = [self.i_enc if i % 2 == 0 else self.u_enc
                 for i in range(nhops + 1)]
        kw = dict(hidden_dim=hidden, out_dim=out_dim, time_dim=time_dim,
                  num_hops=nhops, edge_dim=edge_dim, num_head=num_head,
                  device=device, generator=generator)
        self.u_tower = EgoTGAT(encoders=alt_u, **kw)
        self.i_tower = EgoTGAT(encoders=alt_i, **kw)
        self.scorer = LinkScorePredict(out_dim, device=device,
                                       generator=generator)

    def forward(self, src_tg: TemporalGraph, dst_tg: TemporalGraph,
                neg_tg: TemporalGraph, training: bool = False,
                generator: Optional[torch.Generator] = None):
        kw = dict(training=training, generator=generator)
        return self.scorer(self.u_tower(src_tg, **kw),
                           self.i_tower(dst_tg, **kw),
                           self.i_tower(neg_tg, **kw))


def scores(model: TGATLink, batch: dict, nhops: int, training: bool = False,
           generator: Optional[torch.Generator] = None):
    """(pos, neg) logits [b] of a batch."""
    return model(*[tower(batch, n, nhops) for n in TOWERS],
                 training=training, generator=generator)


def tgat_loss(model: TGATLink, batch: dict, nhops: int,
              training: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return sigmoid_cross_entropy_loss(*scores(model, batch, nhops, training,
                                              generator))


def link_accuracy(model: TGATLink, batch: dict, nhops: int) -> torch.Tensor:
    """Per event: the mean of ``sigmoid(pos) > 0.5`` and ``sigmoid(neg) <
    0.5``."""
    pos, neg = scores(model, batch, nhops)
    return ((torch.sigmoid(pos) > 0.5).float()
            + (torch.sigmoid(neg) < 0.5).float()) / 2.0


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--feat_dim", type=int, default=8)
    ap.add_argument("--edge_feat_dim", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--out_dim", type=int, default=16)
    ap.add_argument("--time_dim", type=int, default=8)
    ap.add_argument("--nbrs", type=int, nargs="+", default=[8, 4])
    ap.add_argument("--events", type=int, default=6000)
    ap.add_argument("--steps_per_epoch", type=int, default=None)
    ap.add_argument("--data_dir",
                    default=os.path.join(tempfile.gettempdir(), "glt_tgat"))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")

    g, udec, idec, _ = load(args.data_dir, args.feat_dim,
                            args.edge_feat_dim, args.events, dev)
    nhops = len(args.nbrs)
    q = build_query(g, args.batch_size, args.nbrs, "train")
    model = TGATLink(udec, idec, args.hidden, args.out_dim, args.time_dim,
                     nhops, args.edge_feat_dim, device=dev)

    def loss_fn(m, batch, generator, training):
        return tgat_loss(m, batch, nhops, training, generator)

    tr = LocalTrainer(device=dev)
    tr.train(q, model, loss_fn, torch.optim.Adam(model.parameters(),
                                                 lr=1e-3),
             epochs=args.epochs, steps_per_epoch=args.steps_per_epoch)
    q_test = build_query(g, args.batch_size, args.nbrs, "test")
    acc = tr.evaluate(q_test, model,
                      lambda m, batch: link_accuracy(m, batch, nhops))
    print("test link-pred acc: %.4f" % acc)
    return acc


if __name__ == "__main__":
    main()
