"""node2vec: biased random walks and a skip-gram with negative sampling.

Counterpart of ``examples/node2vec.py``: ``V("item").batch(b)
.shuffle(traverse=True).random_walk(walk_len, p, q)`` over the undirected
``relation`` edges, window pairs of every walk (``ops/walk.py
skipgram_pairs``), the embedding dot-product loss with ``neg_num`` uniform
negatives per pair, and Adam; then the label coherence of each of the
first 200 nodes' nearest embedding (chance about 1/7).  The embedding
tables ``emb`` and ``ctx`` are parameters, so they are indexed plainly
(Kernel 1 refuses a table that requires a gradient).

The JAX example writes ``examples/data/synthetic.py cora_like:24``'s
graph as TSV files (features to five decimals) and loads it with
``directed=False``; file ingest is not ported, so :func:`cora_like` makes
the same draws in memory (the same generator, seed and defaults, in the
same order) and :func:`build_graph` puts them in the store with
``add_edge_table(..., directed=False)``.

Usage:  python -m graph_learn_tpu_torch.examples.node2vec [--cpu]
            [--epochs N] [--batch_size B] [--walk_len L] [--p P] [--q Q]
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.store import EdgeTable, NodeTable
from graph_learn_tpu_torch.core.traversal import Traverser
from graph_learn_tpu_torch.errors import OutOfRangeError
from graph_learn_tpu_torch.graph import Graph
from graph_learn_tpu_torch.gsl.compile import Query, _execute
from graph_learn_tpu_torch.ops.walk import skipgram_pairs
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

CLASSES, FEAT_DIM = 7, 64


def cora_like(n: int = 1000, classes: int = CLASSES,
              feat_dim: int = FEAT_DIM, avg_degree: int = 8,
              homophily: float = 0.85, feat_noise: float = 2.0,
              seed: int = 0) -> Dict[str, np.ndarray]:
    """``cora_like:24``'s homophilous graph as arrays: labels, unit-norm
    features around each class's centre, and ``n * avg_degree // 2``
    edges, most of them within a class."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n)
    centers = rng.normal(0, 1, (classes, feat_dim))
    feats = centers[labels] + rng.normal(0, feat_noise, (n, feat_dim))
    feats = feats / np.linalg.norm(feats, axis=1, keepdims=True)
    m = n * avg_degree // 2
    src = rng.integers(0, n, 4 * m)
    dst = rng.integers(0, n, 4 * m)
    same = labels[src] == labels[dst]
    keep_same = same & (rng.random(4 * m) < homophily)
    keep_diff = (~same) & (rng.random(4 * m)
                           < (1 - homophily) / max(classes - 1, 1))
    keep = (keep_same | keep_diff) & (src != dst)
    return {"labels": labels.astype(np.int32),
            "feats": feats.astype(np.float32),
            "src": src[keep][:m], "dst": dst[keep][:m]}


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

    a = cora_like()
    g, _ = build_graph(a, dev)
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
