"""Shared pieces of the supervised examples: the Cora-like graph from its
TSV files, the masked 2-hop query, the loss and the accuracy.

Counterpart of the repository's ``examples/common.py``.  The JAX helper
``init_from_first_batch`` (flax modules take their shapes from one sampled
batch) has no counterpart: the port's modules build their weights when
they are constructed.  :func:`cora_like_twin` builds the same store in
memory from the generator's draws, features as the files hold them: the
twin the TSV store is held to.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from graph_learn_tpu_torch.core.schema import Decoder, Mask
from graph_learn_tpu_torch.core.store import EdgeTable, NodeTable
from graph_learn_tpu_torch.examples.data.synthetic import (as_read,
                                                           cora_like,
                                                           cora_like_arrays)
from graph_learn_tpu_torch.graph import Graph
from graph_learn_tpu_torch.gsl.compile import Query
from graph_learn_tpu_torch.nn.data import EgoGraph
from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
from graph_learn_tpu_torch.utils.platform import DeviceLike

SPLITS = (("train", Mask.TRAIN), ("val", Mask.VAL), ("test", Mask.TEST))
RELATIONS = ("relation", "relation2")


def load_cora_like(data_dir: str, feat_dim: int = 64, nodes: int = 1000,
                   classes: int = 7, two_relations: bool = False,
                   device: DeviceLike = "cuda"):
    """(graph, node decoder): the Cora-like tables in ``data_dir``
    (written by ``cora_like`` first if they are missing) through
    :func:`read_cora_layout`."""
    if not os.path.exists(os.path.join(data_dir, "node_table")):
        cora_like(data_dir, n=nodes, classes=classes, feat_dim=feat_dim)
    return read_cora_layout(data_dir, feat_dim, two_relations, device)


def read_cora_layout(data_dir: str, feat_dim: int,
                     two_relations: bool = False,
                     device: DeviceLike = "cuda"):
    """(graph, node decoder): the reference's Cora table layout in
    ``data_dir`` (``cora_like``'s files, or real Cora, ogbn-products or
    any other data the ``examples/data`` writers prepare) through
    ``Graph.node/edge/init``, writing nothing: "item" nodes with labels
    and ``feat_dim`` float features, the undirected weighted ``relation``
    (and, with ``two_relations``, ``relation2`` over the same file), and
    the train / val / test splits."""
    node_decoder = Decoder(labeled=True, attr_types=["float"] * feat_dim)
    g = Graph(device=device).node(os.path.join(data_dir, "node_table"),
                                  "item", node_decoder)
    g.edge(os.path.join(data_dir, "edge_table"),
           ("item", "item", RELATIONS[0]), Decoder(weighted=True),
           directed=False)
    for name, mask in SPLITS:
        g.node(os.path.join(data_dir, name + "_table"), "item",
               Decoder(weighted=True), mask=mask)
    if two_relations:
        g.edge(os.path.join(data_dir, "edge_table"),
               ("item", "item", RELATIONS[1]), Decoder(weighted=True),
               directed=False)
    return g.init(), node_decoder


def cora_like_twin(feat_dim: int = 64, nodes: int = 1000, classes: int = 7,
                   two_relations: bool = False, device: DeviceLike = "cuda"):
    """(graph, node decoder): :func:`load_cora_like`'s store built in
    memory from the draws ``cora_like`` writes (``cora_like_arrays``),
    features as the loader reads their text back."""
    a = cora_like_arrays(n=nodes, classes=classes, feat_dim=feat_dim)
    dec = Decoder(labeled=True, attr_types=["float"] * feat_dim)
    g = Graph(device=device)
    g.add_node_table(NodeTable("item", dec, np.arange(nodes, dtype=np.int64),
                               float_attrs=as_read(a["feats"]),
                               labels=a["labels"]))
    for rel in RELATIONS[:2 if two_relations else 1]:
        g.add_edge_table(EdgeTable(
            rel, "item", "item", Decoder(weighted=True), src=a["src"],
            dst=a["dst"], num_src_nodes=nodes, num_dst_nodes=nodes,
            weights=np.ones(a["src"].size, np.float32)), directed=False)
    for name, mask in SPLITS:
        g.add_node_set("item", a[name], mask,
                       weights=np.ones(a[name].size, np.float32))
    return g, dec


def supervised_query(g: Graph, mask, batch_size: int, nbrs: Sequence[int],
                     edge_type: str = RELATIONS[0],
                     sampler: str = "random") -> Query:
    """``V("item", mask)`` in batches, ``len(nbrs)`` hops aliased
    ``hop1``, ``hop2``, ..."""
    q = g.V("item", mask=mask).batch(batch_size).alias("src")
    for i, k in enumerate(nbrs):
        q = q.outV(edge_type).sample(k).by(sampler).alias("hop%d" % (i + 1))
    return q.values()


def hop_aliases(nbrs: Sequence[int]):
    return ["hop%d" % (i + 1) for i in range(len(nbrs))]


def ego_graph(batch: dict, hops: Sequence[str],
              defer_last: bool = False) -> EgoGraph:
    """The batch's EgoGraph: every hop's rows gathered (Kernel 1 on the
    card), or with ``defer_last`` the deepest hop left to the model's
    reduction straight from the table (Kernel 2)."""
    table = (batch[hops[-1]].float_attrs.table if defer_last and hops
             else None)
    return EgoGraph.from_query_result(batch, "src", hops,
                                      defer_last_table=table)


def supervised_loss_fn(hops: Sequence[str], defer_last: bool = False):
    """``loss_fn(model, batch, generator, training)`` for LocalTrainer:
    softmax cross-entropy of the source nodes' labels."""
    def loss_fn(model, batch, generator, training):
        logits = model(ego_graph(batch, hops, defer_last),
                       training=training, generator=generator)
        return supervised_softmax_loss(logits, batch["src"].labels)
    return loss_fn


def accuracy_fn(hops: Sequence[str], defer_last: bool = False):
    """``metric_fn(model, batch)`` for ``LocalTrainer.evaluate``: 1 where
    the arg max of the logits is the label."""
    def metric_fn(model, batch):
        logits = model(ego_graph(batch, hops, defer_last))
        return (logits.argmax(1) == batch["src"].labels.long()).float()
    return metric_fn
