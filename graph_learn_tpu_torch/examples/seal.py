"""SEAL link prediction: enclosing subgraphs with distance labels.

Counterpart of ``examples/seal.py``: for each (src, dst) pair,
``build_pair_subgraphs:27-49`` samples 6 uniform neighbours of each end,
induces the subgraph over the 14 seeds (cap 14, BFS to depth 2,
ops/subgraph.py), gathers the nodes' features (Kernel 1, one launch per
batch of subgraphs) and appends the one-hot distance labels; a ``GCN``
over the batched subgraphs, a mean readout and a ``LinkPredictor`` score
the pair, and the step (``:110-131``) trains on one random negative dst a
pair with the sigmoid cross-entropy and Adam.  ``SealSteps`` is the
K-step form (``bench.MultiStep``: the pairs drawn on the device, the K
steps captured in one CUDA graph on the card).

Two behaviours of the JAX example are copied as they are:

- the BFS roots are local nodes 0 and 1, the two smallest ids of each
  sorted seed set, not the pair's ends (the JAX comment at ``:38-40``
  says the labels are recomputed from the true positions; the code does
  not);
- the scorer scores the readout against itself, ``scorer(r, r)``
  (``:132``, ``:168``).

The JAX example builds ``GCN([hidden, hidden])`` and flax infers the first
conv's input width, ``feat_dim + steps + 2`` (68 by default, 132 with
ogbl-collab's 128 features); a torch ``Linear`` needs it, so the port's
model states it (:func:`seal_model`).

Data, from files through ``Graph.node/edge/init``, as the JAX example
loads it: by default ``examples/data/synthetic.py cora_like``'s 1 000-node
TSV files in ``--data_dir`` (written first when it has none; the node2vec
example's files, ``node2vec.load``); with ``--collab_dir`` the six
ogbl-collab tables that ``examples/data/ogbl_collab.py
write_collab_tables`` writes (:func:`load_collab`: the nodes' 128 float
features and the undirected weighted train edges), and then the hits@50
of the test pairs against the test negatives (``score_edges:159-191``:
raw ids through the node index, batches of ``--batch_size`` padded with
the first pair, the share of positives above the 50th-highest negative).
With ``--planted`` the planted-community link set of
``tests/test_real_datasets.py:284-305`` (400 nodes in 8 communities, 1 200
train pairs, 200 test pairs and 200 test negatives across communities,
128 features; the set on which the JAX example's ``--collab_dir`` path
reaches hits@50 >= 0.6) is built in memory (:func:`build_graph`): the twin
of its collab tables' store, and the hits@50 likewise.
:func:`planted_collab` draws that set at any counts: ``chip_smoke.py``
draws it at ogbl-collab's counts and widths.

Usage:  python -m graph_learn_tpu_torch.examples.seal [--cpu]
            [--data_dir D | --collab_dir C | --planted] [--steps N]
            [--batch_size B] [--hidden H] [--feat_dim D]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from graph_learn_tpu_torch import bench
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.store import (DeviceEdgeTable, EdgeTable,
                                              NodeTable)
from graph_learn_tpu_torch.examples import node2vec
from graph_learn_tpu_torch.graph import Graph
from graph_learn_tpu_torch.nn.loss import sigmoid_cross_entropy_loss
from graph_learn_tpu_torch.nn.models.sub_models import GCN, LinkPredictor
from graph_learn_tpu_torch.nn.subgraph_data import BatchGraph
from graph_learn_tpu_torch.ops.kernels.dispatch import feature_gather
from graph_learn_tpu_torch.ops.negative import negative_sample
from graph_learn_tpu_torch.ops.sampling import uniform_draw
from graph_learn_tpu_torch.ops.subgraph import induce_batched
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

NBRS, STEPS = 6, 2  # build_pair_subgraphs' defaults
# ogbl-collab's counts and widths (OGB's ogbl-collab: 235 868 authors,
# 1 179 052 train, 60 084 valid and 46 329 test collaborations, 100 000
# valid and test negatives, 128-wide features)
COLLAB_NODES, COLLAB_TRAIN_PAIRS, COLLAB_FEAT = 235_868, 1_179_052, 128
COLLAB_VALID_PAIRS, COLLAB_TEST_PAIRS, COLLAB_NEGATIVES = (60_084, 46_329,
                                                           100_000)
# the six tables of examples/data/ogbl_collab.py write_collab_tables
COLLAB_NODE_TABLE, COLLAB_TRAIN_TABLE = ("ogbl_collab_node",
                                         "ogbl_collab_train_edge")
COLLAB_TEST_TABLE, COLLAB_TEST_NEG_TABLE = ("ogbl_collab_test_edge",
                                            "ogbl_collab_test_edge_neg")


def _pairs(rng: np.random.Generator, n: int, count: int, keep,
           chunk: int = 1 << 20) -> np.ndarray:
    """The first ``count`` pairs ``rng.integers(0, n, 2)`` for which
    ``keep`` holds, drawn in bulk, leaving ``rng`` where a pair-by-pair
    loop would leave it (numpy draws a bulk call's integers in the order
    of single calls)."""
    out, have = [], 0
    while have < count:
        state = rng.bit_generator.state
        cand = rng.integers(0, n, (chunk, 2))
        ok = np.flatnonzero(keep(cand))
        need = count - have
        if ok.size >= need:
            rng.bit_generator.state = state
            rng.integers(0, n, (ok[need - 1] + 1, 2))
            ok = ok[:need]
        out.append(cand[ok])
        have += ok.size
    return np.concatenate(out) if out else np.zeros((0, 2), np.int64)


def planted_collab(n: int = 400, n_train: int = 1200, n_valid: int = 200,
                   n_test: int = 200, n_neg: int = 200, communities: int = 8,
                   feat_dim: int = COLLAB_FEAT, seed: int = 3
                   ) -> Dict[str, np.ndarray]:
    """``tests/test_real_datasets.py:284-305``'s planted-community link
    set at any counts: each node in one of ``communities``; positive pairs
    (train, valid, test) within a community, negatives (valid, test)
    across; features the community's one-hot plus N(0, 0.5) noise, then
    ``feat_dim - communities`` columns of N(0, 0.01).  At its defaults it
    is that test's set, draw for draw."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, communities, n)
    pos = _pairs(rng, n, n_train + n_valid + n_test,
                 lambda c: (c[:, 0] != c[:, 1])
                 & (comm[c[:, 0]] == comm[c[:, 1]]))
    feats = (np.eye(communities)[comm]
             + 0.5 * rng.standard_normal((n, communities))).astype(
                 np.float32)
    feats = np.concatenate(
        [feats, 0.01 * rng.standard_normal(
            (n, feat_dim - communities)).astype(np.float32)], 1)

    def across(k):
        return _pairs(rng, n, k, lambda c: (c[:, 0] != c[:, 1])
                      & (comm[c[:, 0]] != comm[c[:, 1]]))

    valid_neg = across(n_neg if n_valid else 0)
    test_neg = across(n_neg if n_test else 0)
    return {"feats": feats, "comm": comm,
            "train": pos[:n_train],
            "valid": pos[n_train:n_train + n_valid],
            "test": pos[n_train + n_valid:], "valid_neg": valid_neg,
            "test_neg": test_neg}


def build_graph(feats: np.ndarray, src: np.ndarray, dst: np.ndarray,
                device: DeviceLike = "cuda") -> Graph:
    """Node type "item" (float features) and the undirected ``relation``
    edges of weight 1, as the JAX example loads its tables."""
    n, d = feats.shape
    g = Graph(device=device)
    g.add_node_table(NodeTable("item", Decoder(attr_types=["float"] * d),
                               np.arange(n, dtype=np.int64),
                               float_attrs=feats))
    g.add_edge_table(EdgeTable(
        "relation", "item", "item", Decoder(weighted=True), src=src,
        dst=dst, num_src_nodes=n, num_dst_nodes=n,
        weights=np.ones(src.size, np.float32)), directed=False)
    return g


def load_collab(collab_dir: str, device: DeviceLike = "cuda") -> Graph:
    """The ogbl-collab tables of ``collab_dir`` through
    ``Graph.node/edge/init`` (``examples/seal.py:61-69``): node type
    "item" with 128 float features, the undirected weighted ``relation``
    edges of the train table."""
    return (Graph(device=device)
            .node(os.path.join(collab_dir, COLLAB_NODE_TABLE), "item",
                  Decoder(attr_types=["float"] * COLLAB_FEAT))
            .edge(os.path.join(collab_dir, COLLAB_TRAIN_TABLE),
                  ("item", "item", "relation"), Decoder(weighted=True),
                  directed=False)).init()


def _read_edge_tsv(path: str) -> np.ndarray:
    """The (src, dst) raw ids [n, 2] of an edge table, header skipped."""
    return np.loadtxt(path, skiprows=1, usecols=(0, 1), dtype=np.int64,
                      ndmin=2)


def pair_graph(et: DeviceEdgeTable, feats: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, u_src: torch.Tensor, u_dst: torch.Tensor,
               steps: int = STEPS) -> Tuple[BatchGraph, torch.Tensor]:
    """[b] pairs and the uniform draws [b, nbrs] of their neighbours ->
    (BatchGraph of the enclosing subgraphs, node inputs [b * S, D + steps
    + 2]): the features (one Kernel 1 launch) and the one-hot distances to
    local nodes 0 and 1 (the second weighed 2), zero on padding slots."""
    nbrs = u_src.shape[1]
    sn, _ = uniform_draw(et.out, src, u_src)
    dn, _ = uniform_draw(et.out, dst, u_dst)
    seeds = torch.cat([src[:, None], dst[:, None], sn, dn], dim=1)
    sg = induce_batched(et.out, seeds, nbr_cap=nbrs * 2 + 2, need_dist=True,
                        num_bfs_steps=steps)
    bg = BatchGraph.from_subgraphs(sg)
    x = feature_gather(feats, bg.node_ids)
    classes = torch.arange(steps + 2, device=x.device)
    ds = torch.clamp(bg.dist_to_src, 0, steps + 1)
    dd = torch.clamp(bg.dist_to_dst, 0, steps + 1)
    lab = ((ds[:, None] == classes).to(x.dtype)
           + 2.0 * (dd[:, None] == classes).to(x.dtype))
    x = torch.cat([x, lab], dim=-1)
    return bg, torch.where(bg.node_mask[:, None], x, 0.0)


def build_pair_subgraphs(et: DeviceEdgeTable, feats: torch.Tensor,
                         src: torch.Tensor, dst: torch.Tensor,
                         generator: torch.Generator, nbrs: int = NBRS,
                         steps: int = STEPS):
    """:func:`pair_graph` on neighbour draws from ``generator`` (src's,
    then dst's)."""
    u = [torch.rand((src.shape[0], nbrs), generator=generator,
                    device=src.device) for _ in range(2)]
    return pair_graph(et, feats, src, dst, u[0], u[1], steps)


def seal_model(feat_dim: int, hidden: int, steps: int = STEPS,
               device: DeviceLike = "cuda",
               generator: Optional[torch.Generator] = None
               ) -> nn.ModuleDict:
    """{"gcn": GCN([feat_dim + steps + 2, hidden]), "mlp":
    LinkPredictor(hidden)}: the JAX example's two param trees, under the
    same keys."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return nn.ModuleDict({
        "gcn": GCN([feat_dim + steps + 2, hidden], device=device,
                   generator=generator),
        "mlp": LinkPredictor(hidden, device=device, generator=generator)})


def score_graph(model: nn.ModuleDict, bg: BatchGraph,
                x: torch.Tensor) -> torch.Tensor:
    """[b] logits: GCN, mean readout, and the readout scored against
    itself (the JAX example's ``scorer(r, r)``)."""
    h = model["gcn"](bg.edge_index, x, edge_mask=bg.edge_mask)
    r = bg.readout(h)
    return model["mlp"](r, r)


def pairs_loss(model: nn.ModuleDict, et: DeviceEdgeTable,
               feats: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
               neg_dst: torch.Tensor, draws):
    """(loss, pos logits, neg logits) of the pairs (src, dst) against (src,
    neg_dst), on the neighbour draws ``draws``: the positive pairs' src
    and dst draws, then the negative pairs'."""
    pos = score_graph(model, *pair_graph(et, feats, src, dst, *draws[:2]))
    neg = score_graph(model, *pair_graph(et, feats, src, neg_dst,
                                         *draws[2:]))
    return sigmoid_cross_entropy_loss(pos, neg), pos, neg


def seal_loss(model: nn.ModuleDict, et: DeviceEdgeTable,
              feats: torch.Tensor, eidx: torch.Tensor,
              generator: torch.Generator, nbrs: int = NBRS):
    """:func:`pairs_loss` of the train edges ``eidx`` against one random
    negative dst each, drawn from ``generator`` (the negatives, then the
    neighbours)."""
    src, dst = et.src[eidx.long()], et.dst[eidx.long()]
    neg_dst = negative_sample(et, src, 1, generator, "random")[:, 0]
    draws = [torch.rand((src.shape[0], nbrs), generator=generator,
                        device=src.device) for _ in range(4)]
    return pairs_loss(model, et, feats, src, dst, neg_dst, draws)


def train_step(model, optimizer, et, feats, eidx, generator):
    """One step of the JAX example's ``step``: (loss, pairwise AUC proxy),
    both on the device."""
    loss, pos, neg = seal_loss(model, et, feats, eidx, generator)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    auc = (pos.detach()[:, None] > neg.detach()[None, :]).float().mean()
    return loss.detach(), auc


class SealSteps(bench.MultiStep):
    """K SEAL steps a call: ``bench.MultiStep`` with groups of one step
    whose ``b`` train edges are drawn with ``torch.randint`` on the
    device."""

    def __init__(self, model: nn.ModuleDict,
                 optimizer: torch.optim.Optimizer, et: DeviceEdgeTable,
                 feats: torch.Tensor, b: int, K: int,
                 generator: torch.Generator, capture: bool):
        super().__init__(None, None, model, optimizer,
                         {"scan_steps": K, "n_nodes": et.src.shape[0]}, 1,
                         generator, capture)
        self.et, self.feats, self.b = et, feats, b

    def _group(self, first: int):
        eidx = torch.randint(0, self.n_nodes, (self.b,),
                             generator=self.generator,
                             device=self.generator.device, dtype=torch.int32)
        self.seeds.append(eidx)
        loss, _ = train_step(self.model, self.optimizer, self.et,
                             self.feats, eidx, self.generator)
        self.losses[first].copy_(loss)


def score_pairs(model: nn.ModuleDict, et: DeviceEdgeTable,
                feats: torch.Tensor, pairs: np.ndarray, b: int,
                generator: torch.Generator) -> np.ndarray:
    """The logits of ``pairs`` [n, 2] (dense ids), in batches of ``b``, the
    last padded with the first pair (``score_edges:175-188``)."""
    dev = feats.device
    pad = (-len(pairs)) % b
    ep = np.concatenate([pairs, pairs[:1].repeat(pad, 0)]) if pad else pairs
    out = []
    with torch.no_grad():
        for off in range(0, len(ep), b):
            s, t = (torch.as_tensor(ep[off:off + b, j], dtype=torch.int32,
                                    device=dev) for j in (0, 1))
            out.append(score_graph(model, *build_pair_subgraphs(
                et, feats, s, t, generator)))
    return torch.cat(out).cpu().numpy()[:len(pairs)]


def hits_at(pos: np.ndarray, neg: np.ndarray, k: int = 50) -> float:
    """OGB hits@k: the share of positive scores above the k-th highest
    negative score."""
    kth = np.sort(neg)[-min(k, len(neg))]
    return float((pos > kth).mean())


def run(argv=None) -> dict:
    """Load, train and score as :func:`main` does, printing the same
    lines.  Returns {"graph", "auc" (the last step's pairwise AUC),
    "hits" (None without test pairs), "load_s", "train_s", "score_s"},
    seconds on the host clock."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default=node2vec.DEFAULT_DIR)
    ap.add_argument("--collab_dir", default=None,
                    help="ogbl-collab tables from examples/data/"
                         "ogbl_collab.py; enables the hits@50 eval")
    ap.add_argument("--planted", action="store_true",
                    help="the planted-community link set in memory, with "
                         "hits@50")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--feat_dim", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")

    test, score_s = None, 0.0
    t0 = time.perf_counter()
    if args.collab_dir:
        d = args.collab_dir
        args.feat_dim = COLLAB_FEAT
        g = load_collab(d, dev)
        index = g.store.node_table("item").index
        test = tuple(index.lookup(_read_edge_tsv(os.path.join(d, name)))
                     for name in (COLLAB_TEST_TABLE, COLLAB_TEST_NEG_TABLE))
    elif args.planted:
        a = planted_collab()
        args.feat_dim = a["feats"].shape[1]
        g = build_graph(a["feats"], a["train"][:, 0], a["train"][:, 1], dev)
        test = (a["test"], a["test_neg"])
    else:
        g, _ = node2vec.load(args.data_dir, args.feat_dim, device=dev)
    et = g.store.edge_table("relation").device(dev)
    feats = g.store.node_table("item").device(dev).float_attrs
    load_s = time.perf_counter() - t0
    model = seal_model(args.feat_dim, args.hidden, device=dev)
    opt = bench.make_optimizer(model, dev, args.lr)

    gen = torch.Generator(device=dev).manual_seed(5)
    rng = np.random.default_rng(0)
    n_edges = et.src.shape[0]
    t0 = time.perf_counter()
    for i in range(args.steps):
        eidx = torch.as_tensor(rng.integers(0, n_edges, args.batch_size),
                               dtype=torch.int32, device=dev)
        loss, auc = train_step(model, opt, et, feats, eidx, gen)
        if i % 30 == 0 or i == args.steps - 1:
            print("step %d loss %.4f pairwise-auc %.3f"
                  % (i, float(loss), float(auc)))
    auc = float(auc)
    train_s = time.perf_counter() - t0
    hits = None
    if test is not None:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(77)
        ps = score_pairs(model, et, feats, test[0], args.batch_size, gen)
        ns = score_pairs(model, et, feats, test[1], args.batch_size, gen)
        hits = hits_at(ps, ns)
        score_s = time.perf_counter() - t0
        print("hits@50: %.4f" % hits)
    return {"graph": g, "auc": auc, "hits": hits, "load_s": load_s,
            "train_s": train_s, "score_s": score_s}


def main(argv=None) -> float:
    """The hits@50 with test pairs (``--collab_dir``, ``--planted``), else
    the last step's pairwise AUC."""
    out = run(argv)
    return out["auc"] if out["hits"] is None else out["hits"]


if __name__ == "__main__":
    main()
