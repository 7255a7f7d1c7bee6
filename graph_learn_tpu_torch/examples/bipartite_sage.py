"""Bipartite GraphSAGE u2i link prediction with negatives, and recall@k.

Counterpart of ``examples/bipartite_sage.py``: edge seeds on ``u-i``, a
user tower over ``u -> u-i`` items and an item tower over ``i -> i-i``
items, two ``outNeg`` negatives per edge, the in-batch softmax loss
(``unsupervised_softmax_cross_entropy_loss``), trained through
``LocalTrainer.train``; then recall@20 over every user and item embedded
through ``V("u")`` / ``V("i")`` batches.  As the JAX example does,
:func:`load` reads ``examples/data/synthetic.py u2i``'s TSV files
(``user_table``, ``item_table``, ``u2i_table`` and the weighted
``i2i_table``; written first when ``--data_dir`` has none) through
``Graph.node/edge/init``.  :func:`build_graph` builds the same store in
memory from the generator's draws (:func:`u2i_arrays`); given the
features as their five-decimal text reads back (``text=True``) it is the
files' store bit for bit.  Every hop's rows are gathered (Kernel 1 on
the card), as in the JAX example.

Usage:  python -m graph_learn_tpu_torch.examples.bipartite_sage [--cpu]
            [--data_dir D] [--epochs N] [--batch_size B] [--steps_per_epoch S]
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
from graph_learn_tpu_torch.errors import OutOfRangeError
from graph_learn_tpu_torch.examples.data import synthetic
from graph_learn_tpu_torch.graph import Graph
from graph_learn_tpu_torch.gsl.compile import Query
from graph_learn_tpu_torch.gsl.dataset import Dataset
from graph_learn_tpu_torch.nn.data import EgoGraph
from graph_learn_tpu_torch.nn.feature_column import FeatureEncoder
from graph_learn_tpu_torch.nn.layers.ego import (EgoLayer, EgoSAGEConv,
                                                 init_linear)
from graph_learn_tpu_torch.nn.loss import \
    unsupervised_softmax_cross_entropy_loss
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGNN
from graph_learn_tpu_torch.nn.trainer import LocalTrainer
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device


DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "glt_u2i_ex")


def u2i_arrays(n_users: int = 500, n_items: int = 300, n_clusters: int = 5,
               edges_per_user: int = 10, feat_dim: int = 16,
               seed: int = 0, text: bool = False) -> Dict[str, np.ndarray]:
    """The bipartite user-item graph of ``examples/data/synthetic.py u2i``
    as arrays: users and items in clusters, each user linked to items of
    its cluster, items linked within their cluster; every weight 1.
    Features float32, or with ``text`` as the loader reads back their
    five-decimal text."""
    rng = np.random.default_rng(seed)
    u_cluster = rng.integers(0, n_clusters, n_users)
    i_cluster = rng.integers(0, n_clusters, n_items)
    u_feat = rng.normal(0, 1, (n_users, feat_dim)) + \
        3.0 * np.eye(n_clusters)[u_cluster] @ rng.normal(
            0, 1, (n_clusters, feat_dim))
    i_feat = rng.normal(0, 1, (n_items, feat_dim)) + \
        3.0 * np.eye(n_clusters)[i_cluster] @ rng.normal(
            0, 1, (n_clusters, feat_dim))
    srcs, dsts = [], []
    item_by_cluster = [np.where(i_cluster == c)[0] for c in range(n_clusters)]
    for u in range(n_users):
        pool = item_by_cluster[u_cluster[u]]
        if pool.size == 0:
            pool = np.arange(n_items)
        picks = rng.choice(pool, size=min(edges_per_user, pool.size),
                           replace=False)
        srcs.extend([u] * len(picks))
        dsts.extend(picks.tolist())
    ii_src, ii_dst = [], []
    for c in range(n_clusters):
        items = item_by_cluster[c]
        for i in items:
            nbrs = rng.choice(items, size=min(5, items.size), replace=False)
            for j in nbrs:
                if i != j:
                    ii_src.append(i)
                    ii_dst.append(j)
    cast = synthetic.as_read if text else (lambda x: x.astype(np.float32))
    return {"u_feat": cast(u_feat), "i_feat": cast(i_feat),
            "ui_src": np.asarray(srcs, np.int64),
            "ui_dst": np.asarray(dsts, np.int64),
            "ii_src": np.asarray(ii_src, np.int64),
            "ii_dst": np.asarray(ii_dst, np.int64)}


def load(data_dir: str, feat_dim: int = 16, device: DeviceLike = "cuda"
         ) -> Tuple[Graph, Decoder, Decoder]:
    """(graph, user decoder, item decoder) from ``synthetic.u2i``'s files
    in ``data_dir`` (written first if they are missing), through
    ``Graph.node/edge/init`` as the JAX example's ``load:30-41`` reads
    them."""
    if not os.path.exists(os.path.join(data_dir, "user_table")):
        synthetic.u2i(data_dir, feat_dim=feat_dim)
    udec = Decoder(attr_types=["float"] * feat_dim)
    idec = Decoder(attr_types=["float"] * feat_dim)
    g = (Graph(device=device)
         .node(os.path.join(data_dir, "user_table"), "u", udec)
         .node(os.path.join(data_dir, "item_table"), "i", idec)
         .edge(os.path.join(data_dir, "u2i_table"), ("u", "i", "u-i"),
               Decoder(weighted=True))
         .edge(os.path.join(data_dir, "i2i_table"), ("i", "i", "i-i"),
               Decoder(weighted=True)))
    return g.init(), udec, idec


def build_graph(a: Dict[str, np.ndarray], device: DeviceLike = "cuda"
                ) -> Tuple[Graph, Decoder, Decoder]:
    """Node types "u" and "i" with float features, weighted edge types
    "u-i" and "i-i" (weights 1), as the JAX example loads them."""
    n_u, d = a["u_feat"].shape
    n_i = a["i_feat"].shape[0]
    udec = Decoder(attr_types=["float"] * d)
    idec = Decoder(attr_types=["float"] * d)
    g = Graph(device=device)
    g.add_node_table(NodeTable("u", udec, np.arange(n_u, dtype=np.int64),
                               float_attrs=a["u_feat"]))
    g.add_node_table(NodeTable("i", idec, np.arange(n_i, dtype=np.int64),
                               float_attrs=a["i_feat"]))
    for name, s_t, src, dst, n_s in (("u-i", "u", a["ui_src"], a["ui_dst"],
                                      n_u),
                                     ("i-i", "i", a["ii_src"], a["ii_dst"],
                                      n_i)):
        g.add_edge_table(EdgeTable(
            name, s_t, "i", Decoder(weighted=True), src=src, dst=dst,
            num_src_nodes=n_s, num_dst_nodes=n_i,
            weights=np.ones(src.size, np.float32)))
    return g, udec, idec


def build_query(g: Graph, batch_size: int, nbrs: Sequence[int],
                n_neg: int = 2) -> Query:
    """u tower: u -> u-i items; i tower: i -> i-i items (reference
    train.py:88-112)."""
    seed = g.E("u-i").batch(batch_size).shuffle(traverse=True).alias("seed")
    src = seed.outV().alias("src")
    dst = seed.inV().alias("dst")
    neg = src.outNeg("u-i").sample(n_neg).by("random").alias("neg")
    src.outV("u-i").sample(nbrs[0]).by("random").alias("src_h1")
    dst.outV("i-i").sample(nbrs[0]).by("random").alias("dst_h1")
    neg.outV("i-i").sample(nbrs[0]).by("random").alias("neg_h1")
    return seed.values()


def tower(decoders: Sequence[Decoder], in_dim, out_dim: int,
          generator: torch.Generator) -> EgoGNN:
    """One EgoSAGEConv(mean) layer over per-hop FeatureEncoders, its
    weights drawn from ``generator`` (the encoders' embedding tables
    first); ``in_dim`` is the encoders' width, or the (src, hop) pair of
    widths."""
    if isinstance(in_dim, int):
        in_dim = (in_dim, in_dim)
    model = EgoGNN([EgoLayer([EgoSAGEConv(tuple(in_dim), out_dim,
                                          agg_type="mean")])],
                   hop_encoders=[FeatureEncoder(d, generator=generator)
                                 for d in decoders])
    for m in model.modules():
        if isinstance(m, nn.Linear):
            init_linear(m, generator)
    return model


def towers(udec: Decoder, idec: Decoder, out_dim: int,
           device: DeviceLike = "cuda",
           generator: Optional[torch.Generator] = None) -> nn.ModuleDict:
    """{"u": user tower, "i": item tower}; weights drawn on the CPU from
    ``generator`` (default: seeded with 0), then moved to ``device``.
    Each tower's input widths are its encoders' (``FeatureEncoder.out_dim``:
    the float attributes plus the embedding columns' widths)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    wu, wi = FeatureEncoder.out_dim(udec), FeatureEncoder.out_dim(idec)
    return nn.ModuleDict({
        "u": tower([udec, idec], (wu, wi), out_dim, generator),
        "i": tower([idec, idec], (wi, wi), out_dim, generator),
    }).to(resolve_device(device))


def egos(batch: dict, defer_table: Optional[torch.Tensor] = None):
    """The src, dst and negative EgoGraphs of a batch; the negatives'
    [b, n_neg] seeds and [b, n_neg, k] hop are flattened to rows.  With
    ``defer_table`` (the item feature table) every tower's hop is left
    deferred for EgoGNN to reduce straight from the table (Kernel 2);
    else every hop's rows are gathered."""
    src = EgoGraph.from_query_result(batch, "src", ["src_h1"],
                                     defer_last_table=defer_table)
    dst = EgoGraph.from_query_result(batch, "dst", ["dst_h1"],
                                     defer_last_table=defer_table)
    neg_h1 = batch["neg_h1"]
    flat = {"neg": batch["neg"].flat(),
            "neg_h1": neg_h1.map(
                lambda x: x.reshape((-1,) + tuple(x.shape[2:])))}
    neg = EgoGraph.from_query_result(flat, "neg", ["neg_h1"],
                                     defer_last_table=defer_table)
    return src, dst, neg


def tower_loss(model: nn.ModuleDict, batch: dict,
               defer_table: Optional[torch.Tensor] = None,
               training: bool = True) -> torch.Tensor:
    src, dst, neg = egos(batch, defer_table)
    u = model["u"](src, training=training)
    i = model["i"](dst, training=training)
    n = model["i"](neg, training=training)
    return unsupervised_softmax_cross_entropy_loss(u, i, n)


def loss_fn(model: nn.ModuleDict, batch: dict, generator, training):
    """``LocalTrainer``'s loss: both towers on the gathered egos."""
    return tower_loss(model, batch, training=training)


def eval_recall(g: Graph, model: nn.ModuleDict, nbrs: Sequence[int],
                k: int = 20, device: DeviceLike = "cuda") -> float:
    """Recall@k: every user ranks every item by the dot product of their
    towers' embeddings; hits among the top k over min(|truth|, k)."""
    dev = resolve_device(device)
    uq = (g.V("u").batch(64).alias("src")
          .outV("u-i").sample(nbrs[0]).by("random").alias("src_h1").values())
    iq = (g.V("i").batch(64).alias("src")
          .outV("i-i").sample(nbrs[0]).by("random").alias("src_h1").values())

    def embed_all(q, tower_):
        ds = Dataset(q, window=1, device=dev)
        embs, ids = [], []
        with torch.no_grad():
            while True:
                try:
                    batch, count = ds.next_with_count()
                except OutOfRangeError:
                    break
                ego = EgoGraph.from_query_result(batch, "src", ["src_h1"])
                embs.append(tower_(ego, training=False)[:count])
                ids.append(batch["src"].ids[:count])
        return torch.cat(embs), torch.cat(ids).cpu().numpy()

    u_emb, u_ids = embed_all(uq, model["u"])
    i_emb, i_ids = embed_all(iq, model["i"])
    top = torch.topk(u_emb @ i_emb.T, min(k, i_emb.shape[0]),
                     dim=1).indices.cpu().numpy()
    et = g.store.edge_table("u-i")
    truth: Dict[int, set] = {}
    for s, d in zip(et.src, et.dst):
        truth.setdefault(int(s), set()).add(int(d))
    hits, total = 0, 0
    for row, u in enumerate(u_ids):
        t = truth.get(int(u), set())
        if not t:
            continue
        hits += len({int(i_ids[c]) for c in top[row]} & t)
        total += min(len(t), k)
    return hits / max(total, 1)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default=DEFAULT_DIR)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--feat_dim", type=int, default=16)
    ap.add_argument("--out_dim", type=int, default=32)
    ap.add_argument("--nbrs", type=int, nargs="+", default=[5])
    ap.add_argument("--lr", type=float, default=0.005)
    ap.add_argument("--steps_per_epoch", type=int, default=30)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")

    g, udec, idec = load(args.data_dir, args.feat_dim, dev)
    model = towers(udec, idec, args.out_dim, dev)
    q = build_query(g, args.batch_size, args.nbrs)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    _, hist = LocalTrainer(device=dev).train(
        q, model, loss_fn, opt, epochs=args.epochs,
        steps_per_epoch=args.steps_per_epoch)
    recall = eval_recall(g, model, args.nbrs, k=20, device=dev)
    print("recall@20: %.4f" % recall)
    return recall


if __name__ == "__main__":
    main()
