"""TGN-style temporal link prediction with a node memory.

Counterpart of ``examples/tgn.py``: events stream in timestamp order in
batches; each user and item keeps a memory, seeded from its features; a
batch scores (user, item) against (user, one ``random`` negative item)
with ``TGNScorer`` over the user's memory refreshed by a GRU from its most
recent earlier neighbour, the mean memory of its ``nbrs`` most recent
neighbours strictly before the event (``ops/temporal.py
temporal_topk_sample``) and the items' memories and features; the sigmoid
cross-entropy and Adam train the scorer and the GRU; then, after scoring
and with the weights the batch was scored with, both endpoints' memories
are updated by the GRU from the event's message (``tgn.py:110-150``).
The pairwise AUC is the share of events whose positive scores above its
negative.

The item features are a table that is no parameter, so their rows are
read by Kernel 1 (``feature_gather``): two launches a step on the card.
The flax ``GRUCell`` is a ``torch.nn.GRUCell`` (:func:`gru_cell`): flax
gives the input projections the biases and the hidden ones only ``hn``'s,
so the torch cell's ``b_hr`` and ``b_hz`` start at zero and a gradient
hook keeps them there; ``nn/convert.py`` carries the weights across.

As the JAX example does, the stream is ``gen_temporal_u2i``'s TSV files
(:func:`write_temporal_u2i`, the port's copy of ``examples/tgn.py:27``:
the same draws and bytes, features to three decimals, items' raw ids
from 100 000, timestamps from 1 000; written first when ``--data_dir``
has none), loaded by :func:`load` through ``Graph.node/edge/init``.
:func:`build_graph` builds the same store in memory from the same draws
(:func:`gen_temporal_u2i`), each feature read back from its text as the
loader reads it: the files' store bit for bit.

Usage:  python -m graph_learn_tpu_torch.examples.tgn [--cpu]
            [--data_dir D] [--epochs N] [--batch_size B] [--nbrs K]
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.store import EdgeTable, NodeTable
from graph_learn_tpu_torch.graph import Graph
from graph_learn_tpu_torch.nn.layers.ego import init_linear
from graph_learn_tpu_torch.ops.kernels.dispatch import feature_gather
from graph_learn_tpu_torch.ops.negative import negative_sample
from graph_learn_tpu_torch.ops.temporal import temporal_topk_sample
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

FEAT_DIM, N_CLUSTERS = 8, 4
# raw id of the first item, and the first event's timestamp
ITEM_ID0, TS0 = 100_000, 1000
DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "glt_tgn")


def _three_decimals(x: np.ndarray) -> np.ndarray:
    """``x`` as the loader reads it back from its ``%.3f`` text."""
    return np.asarray(["%.3f" % v for v in x], dtype=np.float32)


def temporal_draws(n_u: int = 200, n_i: int = 150, events: int = 4000,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """``tgn.py gen_temporal_u2i:27``'s draws, in its order: users and
    items in four clusters with float64 features around their cluster's
    centre, and ``events`` (user, item of its cluster) one time unit
    apart from ``TS0``."""
    rng = np.random.default_rng(seed)
    cu = rng.integers(0, N_CLUSTERS, n_u)
    ci = rng.integers(0, N_CLUSTERS, n_i)
    centers = rng.normal(0, 1.5, (N_CLUSTERS, FEAT_DIM))
    u_feat = np.stack([centers[cu[i]] + rng.normal(0, 0.5, FEAT_DIM)
                       for i in range(n_u)])
    i_feat = np.stack([centers[ci[i]] + rng.normal(0, 0.5, FEAT_DIM)
                       for i in range(n_i)])
    src = np.empty(events, np.int64)
    dst = np.empty(events, np.int64)
    for t in range(events):
        u = rng.integers(0, n_u)
        pool = np.where(ci == cu[u])[0]
        src[t] = u
        dst[t] = (pool[rng.integers(0, pool.size)] if pool.size
                  else rng.integers(0, n_i))
    return {"u_feat": u_feat, "i_feat": i_feat, "src": src, "dst": dst,
            "ts": TS0 + np.arange(events, dtype=np.int64)}


def gen_temporal_u2i(n_u: int = 200, n_i: int = 150, events: int = 4000,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """:func:`temporal_draws` with each feature as the loader reads back
    its three-decimal text (float32)."""
    a = temporal_draws(n_u, n_i, events, seed)
    for k in ("u_feat", "i_feat"):
        a[k] = np.stack([_three_decimals(row) for row in a[k]])
    return a


def write_temporal_u2i(path: str, n_u: int = 200, n_i: int = 150,
                       events: int = 4000, seed: int = 0):
    """``tgn.py gen_temporal_u2i:27``'s files, byte for byte:
    ``user_table`` and ``item_table`` (``id:int64\tfeature:string``,
    ``%.3f`` features, items from raw id ``ITEM_ID0``) and the
    ``event_table`` (``src_id dst_id timestamp``).  Returns (n_u, n_i)."""
    a = temporal_draws(n_u, n_i, events, seed)
    os.makedirs(path, exist_ok=True)
    for name, feats, id0 in (("user_table", a["u_feat"], 0),
                             ("item_table", a["i_feat"], ITEM_ID0)):
        with open(os.path.join(path, name), "w") as f:
            f.write("id:int64\tfeature:string\n")
            for i, feat in enumerate(feats):
                f.write("%d\t%s\n" % (i + id0,
                                      ":".join("%.3f" % x for x in feat)))
    with open(os.path.join(path, "event_table"), "w") as f:
        f.write("src_id:int64\tdst_id:int64\ttimestamp:int64\n")
        for u, i, ts in zip(a["src"], a["dst"], a["ts"]):
            f.write("%d\t%d\t%d\n" % (u, i + ITEM_ID0, ts))
    return n_u, n_i


def load(data_dir: str, device: DeviceLike = "cuda") -> Graph:
    """The example's store from ``gen_temporal_u2i``'s files in
    ``data_dir`` (written first if they are missing) through
    ``Graph.node/edge/init`` (``tgn.py:81-89``): node types "u" and "i"
    with float features, the timestamped ``ev`` edges."""
    if not os.path.exists(os.path.join(data_dir, "event_table")):
        write_temporal_u2i(data_dir)
    return (Graph(device=device)
            .node(os.path.join(data_dir, "user_table"), "u",
                  Decoder(attr_types=["float"] * FEAT_DIM))
            .node(os.path.join(data_dir, "item_table"), "i",
                  Decoder(attr_types=["float"] * FEAT_DIM))
            .edge(os.path.join(data_dir, "event_table"), ("u", "i", "ev"),
                  Decoder(timestamped=True))).init()


def build_graph(a: Dict[str, np.ndarray], device: DeviceLike = "cuda"
                ) -> Graph:
    """Node types "u" and "i" (raw ids from ``ITEM_ID0``) with float
    features, and the timestamped ``ev`` edges, as the JAX example loads
    them."""
    n_u, d = a["u_feat"].shape
    n_i = a["i_feat"].shape[0]
    g = Graph(device=device)
    g.add_node_table(NodeTable("u", Decoder(attr_types=["float"] * d),
                               np.arange(n_u, dtype=np.int64),
                               float_attrs=a["u_feat"]))
    g.add_node_table(NodeTable("i", Decoder(attr_types=["float"] * d),
                               ITEM_ID0 + np.arange(n_i, dtype=np.int64),
                               float_attrs=a["i_feat"]))
    g.add_edge_table(EdgeTable(
        "ev", "u", "i", Decoder(timestamped=True), src=a["src"],
        dst=a["dst"], num_src_nodes=n_u, num_dst_nodes=n_i,
        timestamps=a["ts"]))
    return g


class TGNScorer(nn.Module):
    """``tgn.py TGNScorer:56``: the user's memory with the mean memory of
    its recent neighbours, the item's memory with its features, each
    projected to ``mem_dim``; the score is their dot product."""

    def __init__(self, mem_dim: int, feat_dim: int = FEAT_DIM):
        super().__init__()
        self.proj_u = nn.Linear(2 * mem_dim, mem_dim)
        self.proj_i = nn.Linear(mem_dim + feat_dim, mem_dim)

    def forward(self, u_mem, i_mem, u_nbr_mem, i_feat):
        ctx = u_nbr_mem.mean(dim=1)
        h_u = self.proj_u(torch.cat([u_mem, ctx], -1))
        h_i = self.proj_i(torch.cat([i_mem, i_feat], -1))
        return (h_u * h_i).sum(-1)


def gru_cell(in_dim: int, mem_dim: int, generator: torch.Generator,
             device: DeviceLike = "cuda") -> nn.GRUCell:
    """A ``torch.nn.GRUCell`` laid out as flax's ``GRUCell``: LeCun-normal
    input weights, orthogonal hidden weights, zero biases, and the hidden
    biases of the r and z gates held at zero (flax has none there)."""
    cell = nn.GRUCell(in_dim, mem_dim, device=resolve_device(device))
    with torch.no_grad():
        cell.weight_ih.normal_(0.0, in_dim ** -0.5, generator=generator)
        for g in cell.weight_hh.chunk(3):
            nn.init.orthogonal_(g, generator=generator)
        cell.bias_ih.zero_()
        cell.bias_hh.zero_()
    keep = torch.ones(3 * mem_dim, device=cell.bias_hh.device)
    keep[:2 * mem_dim] = 0.0
    cell.bias_hh.register_hook(lambda grad: grad * keep)
    return cell


def make_model(mem_dim: int, seed: int = 0,
               device: DeviceLike = "cuda") -> nn.ModuleDict:
    """{"scorer": TGNScorer, "gru": the memory GRU}: the tree of the JAX
    example's params, ``{"scorer": ..., "gru": ...}``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    scorer = TGNScorer(mem_dim).to(dev)
    for m in scorer.modules():
        if isinstance(m, nn.Linear):
            init_linear(m, gen)
    return nn.ModuleDict({"scorer": scorer,
                          "gru": gru_cell(2 * mem_dim, mem_dim, gen, dev)})


def tgn_loss(model: nn.ModuleDict, mem_u: torch.Tensor, mem_i: torch.Tensor,
             i_feat: torch.Tensor, uu: torch.Tensor, ii: torch.Tensor,
             neg: torch.Tensor, nbr_i: torch.Tensor):
    """(loss, pos, neg scores) of a batch of events (``tgn.py:lf``): the
    user's memory GRU-refreshed from its most recent earlier neighbour's,
    then the positive and negative items scored."""
    nbr_m = mem_i[torch.clamp(nbr_i, min=0)]
    last_msg = torch.cat([mem_u[uu], nbr_m[:, 0]], -1)
    u_m = model["gru"](last_msg, mem_u[uu])
    pos = model["scorer"](u_m, mem_i[ii], nbr_m, feature_gather(i_feat, ii))
    negs = model["scorer"](u_m, mem_i[neg], nbr_m,
                           feature_gather(i_feat, neg))
    loss = F.binary_cross_entropy_with_logits(pos, torch.ones_like(pos))
    loss = loss + F.binary_cross_entropy_with_logits(negs,
                                                     torch.zeros_like(negs))
    return loss, pos, negs


def tgn_step(model: nn.ModuleDict, opt: torch.optim.Optimizer, tables,
             mem: Tuple[torch.Tensor, torch.Tensor], eidx: torch.Tensor,
             neg: torch.Tensor, nbrs: int):
    """One batch (``tgn.py:step``): the loss and its Adam step, then the
    memories updated after scoring, with the weights the batch was scored
    with.  ``neg`` [b] are the events' negative items.  Returns (loss,
    the pairwise AUC of the batch); ``mem`` is updated in place."""
    et, i_feat = tables
    mem_u, mem_i = mem
    uu, ii, ts = et.src[eidx], et.dst[eidx], et.timestamps[eidx]
    nbr_i, _ = temporal_topk_sample(et.out, uu, nbrs, ts)
    loss, pos, negs = tgn_loss(model, mem_u, mem_i, i_feat, uu, ii, neg,
                               nbr_i)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    with torch.no_grad():
        gru = model["gru"]
        new_u = gru(torch.cat([mem_u[uu], mem_i[ii]], -1), mem_u[uu])
        new_i = gru(torch.cat([mem_i[ii], mem_u[uu]], -1), mem_i[ii])
        mem_u[uu.long()] = new_u
        mem_i[ii.long()] = new_i
    opt.step()
    return loss.detach(), (pos > negs).to(torch.float32).mean()


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default=DEFAULT_DIR)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--mem_dim", type=int, default=32)
    ap.add_argument("--nbrs", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--lr", type=float, default=0.003)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")

    g = load(args.data_dir, dev)
    host = g.store.edge_table("ev")
    et = host.device(dev)
    i_feat = g.store.node_table("i").device(dev).float_attrs
    u_feat = g.store.node_table("u").device(dev).float_attrs.float()
    # time-ordered event stream (temporal_batch_loader parity)
    order = np.argsort(host.timestamps, kind="stable")
    model = make_model(args.mem_dim, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    # feature-seeded memories (zero init makes all nodes indistinguishable)
    proj = 0.5 * torch.randn((FEAT_DIM, args.mem_dim), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(42))
    b = args.batch_size
    for epoch in range(args.epochs):
        mem = (u_feat @ proj, i_feat.float() @ proj)
        gen = torch.Generator(device=dev).manual_seed(7 + epoch)
        aucs, losses = [], []
        for off in range(0, len(order) - b, b):
            eidx = torch.as_tensor(order[off:off + b], dtype=torch.int64,
                                   device=dev)
            neg = negative_sample(et, et.src[eidx], 1, gen, "random")[:, 0]
            loss, auc = tgn_step(model, opt, (et, i_feat), mem, eidx, neg,
                                 args.nbrs)
            losses.append(loss)
            aucs.append(auc)
        aucs = torch.stack(aucs).cpu().numpy()
        print("epoch %d loss %.4f pairwise-auc %.3f (last quarter %.3f)"
              % (epoch, float(torch.stack(losses).mean()), np.mean(aucs),
                 np.mean(aucs[-len(aucs) // 4:])), flush=True)
    return float(np.mean(aucs[-len(aucs) // 4:]))


if __name__ == "__main__":
    main()
