"""node2vec: biased random walks and a skip-gram with negative sampling.

Counterpart of ``examples/node2vec.py``: ``V("item").batch(b)
.shuffle(traverse=True).random_walk(walk_len, p, q)`` over the undirected
``relation`` edges, window pairs of every walk (``ops/walk.py
skipgram_pairs``), the embedding dot-product loss with ``neg_num`` uniform
negatives per pair, and Adam; then the label coherence of each of the
first 200 nodes' nearest embedding (chance about 1/7).  The embedding
tables ``emb`` and ``ctx`` are parameters, so they are indexed plainly
(Kernel 1 refuses a table that requires a gradient).

As the JAX example does, :func:`load` reads ``examples/data/synthetic.py
cora_like:24``'s TSV files (written first when ``--data_dir`` has none;
features to five decimals) through ``Graph.node/edge/init`` with the
``relation`` edges undirected.  :func:`build_graph` builds the same store
in memory from the generator's draws (:func:`cora_like`); given the
features as their text reads back (``text=True``) it is the files' store
bit for bit.

Usage:  python -m graph_learn_tpu_torch.examples.node2vec [--cpu]
            [--data_dir D] [--epochs N] [--batch_size B] [--walk_len L]
            [--p P] [--q Q]
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.store import EdgeTable, NodeTable
from graph_learn_tpu_torch.core.traversal import Traverser
from graph_learn_tpu_torch.errors import OutOfRangeError
from graph_learn_tpu_torch.examples.data import synthetic
from graph_learn_tpu_torch.graph import Graph
from graph_learn_tpu_torch.gsl.compile import Query, _execute
from graph_learn_tpu_torch.ops.walk import skipgram_pairs
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

CLASSES, FEAT_DIM, NODES = 7, 64, 1000
DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "glt_cora_like")


def cora_like(n: int = NODES, classes: int = CLASSES,
              feat_dim: int = FEAT_DIM, avg_degree: int = 8,
              homophily: float = 0.85, feat_noise: float = 2.0,
              seed: int = 0, text: bool = False) -> Dict[str, np.ndarray]:
    """``cora_like:24``'s homophilous graph as arrays
    (``synthetic.cora_like_arrays``): int32 labels, unit-norm float32
    features around each class's centre (with ``text``, as the loader
    reads back their five-decimal text), and ``n * avg_degree // 2``
    edges, most of them within a class."""
    a = synthetic.cora_like_arrays(n, classes, feat_dim, avg_degree,
                                   homophily, feat_noise, seed=seed)
    feats = (synthetic.as_read(a["feats"]) if text
             else a["feats"].astype(np.float32))
    return {"labels": a["labels"].astype(np.int32), "feats": feats,
            "src": a["src"], "dst": a["dst"]}


def load(data_dir: str, feat_dim: int = FEAT_DIM, n: int = NODES,
         edge_type: str = "relation", node_type: str = "item",
         device: DeviceLike = "cuda") -> Tuple[Graph, Decoder]:
    """(graph, node decoder) from ``cora_like``'s ``node_table`` and
    ``edge_table`` in ``data_dir`` (written first, ``n`` nodes of
    ``feat_dim`` features, if they are missing) through
    ``Graph.node/edge/init``: ``node_type`` with labels and float
    features, the undirected weighted ``edge_type`` edges
    (``examples/node2vec.py:39-46``; ``sage_unsupervised.py load``)."""
    if not os.path.exists(os.path.join(data_dir, "node_table")):
        synthetic.cora_like(data_dir, n=n, classes=CLASSES,
                            feat_dim=feat_dim)
    dec = Decoder(labeled=True, attr_types=["float"] * feat_dim)
    g = (Graph(device=device)
         .node(os.path.join(data_dir, "node_table"), node_type, dec)
         .edge(os.path.join(data_dir, "edge_table"),
               (node_type, node_type, edge_type), Decoder(weighted=True),
               directed=False))
    return g.init(), dec


def build_graph(a: Dict[str, np.ndarray], device: DeviceLike = "cuda"
                ) -> Tuple[Graph, Decoder]:
    """Node type "item" (labels, float features) and the undirected,
    weighted (weights 1) ``relation`` edges, as the JAX example loads
    them."""
    n, d = a["feats"].shape
    dec = Decoder(labeled=True, attr_types=["float"] * d)
    g = Graph(device=device)
    g.add_node_table(NodeTable("item", dec, np.arange(n, dtype=np.int64),
                               float_attrs=a["feats"], labels=a["labels"]))
    g.add_edge_table(EdgeTable(
        "relation", "item", "item", Decoder(weighted=True), src=a["src"],
        dst=a["dst"], num_src_nodes=n, num_dst_nodes=n,
        weights=np.ones(a["src"].size, np.float32)), directed=False)
    return g, dec


def build_query(g: Graph, batch_size: int, walk_len: int, p: float,
                q: float) -> Query:
    """The example's query: shuffled seeds, one walk each."""
    return (g.V("item").batch(batch_size).shuffle(traverse=True).alias("src")
            .random_walk(walk_len, p=p, q=q, edge_type="relation")
            .alias("walks").values())


def skipgram_loss(emb: torch.Tensor, ctx: torch.Tensor, pairs,
                  negs: torch.Tensor) -> torch.Tensor:
    """The mean over the valid ``pairs`` (``skipgram_pairs``' target,
    context, valid) of ``-log σ(t·c) - Σ log σ(-t·n)`` with the negatives
    ``negs`` [b, P, neg_num] (``node2vec.py:lf``)."""
    t, c, valid = pairs
    te = emb[torch.clamp(t, min=0)]
    ce = ctx[torch.clamp(c, min=0)]
    pos = (te * ce).sum(-1)
    neg = torch.einsum("bpd,bpnd->bpn", te, ctx[negs])
    w = valid.to(torch.float32)
    loss = -(F.logsigmoid(pos) * w).sum()
    loss = loss - (F.logsigmoid(-neg) * w[..., None]).sum()
    return loss / torch.clamp(w.sum(), min=1.0)


def label_coherence(emb: np.ndarray, labels: np.ndarray,
                    probe: int = 200) -> float:
    """Share of the first ``probe`` nodes whose nearest other embedding
    (cosine) has their label (``node2vec.py:96-107``)."""
    e = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    sims = e[:probe] @ e.T
    np.fill_diagonal(sims[:, :probe], -1)
    nn_idx = np.argmax(sims, axis=1)
    return float((labels[:probe] == labels[nn_idx]).mean())


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default=DEFAULT_DIR)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--walk_len", type=int, default=10)
    ap.add_argument("--window", type=int, default=5)
    ap.add_argument("--emb_dim", type=int, default=64)
    ap.add_argument("--neg_num", type=int, default=5)
    ap.add_argument("--p", type=float, default=0.25)
    ap.add_argument("--q", type=float, default=0.25)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")

    g, _ = load(args.data_dir, device=dev)
    q = build_query(g, args.batch_size, args.walk_len, args.p, args.q)
    n = g.store.node_table("item").num_nodes
    tables = q.device_tables()
    init = torch.Generator(device=dev).manual_seed(0)
    emb = torch.nn.Parameter(0.1 * torch.randn(
        (n, args.emb_dim), generator=init, device=dev))
    ctx = torch.nn.Parameter(0.1 * torch.randn(
        (n, args.emb_dim), generator=init, device=dev))
    opt = torch.optim.Adam([emb, ctx], lr=args.lr)
    gen = torch.Generator(device=dev).manual_seed(7)
    trav = Traverser(n, args.batch_size, "shuffle")
    for epoch in range(args.epochs):
        losses = []
        while True:
            try:
                pos, _ = trav.next()
            except OutOfRangeError:
                break
            seeds = torch.as_tensor(pos, dtype=torch.int32, device=dev)
            with torch.no_grad():
                walks = _execute(q, tables, seeds, gen)["walks"].ids
            pairs = skipgram_pairs(walks, args.window)
            negs = torch.randint(0, n, pairs[0].shape + (args.neg_num,),
                                 generator=gen, device=dev)
            loss = skipgram_loss(emb, ctx, pairs, negs)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        print("epoch %d loss %.4f"
              % (epoch, float(torch.stack(losses).mean())), flush=True)

    coherence = label_coherence(emb.detach().cpu().numpy(),
                                g.store.node_table("item").labels)
    print("nn label coherence: %.3f (chance ~%.3f)"
          % (coherence, 1.0 / CLASSES), flush=True)
    return coherence


if __name__ == "__main__":
    main()
