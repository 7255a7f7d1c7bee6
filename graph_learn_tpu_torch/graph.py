"""Graph facade: in-memory table registration, lookups, the ``V()`` and
``E()`` entries.

Counterpart of ``graph_learn_tpu/graph.py:47-321`` for tables built in
memory, as ``bench.py:84-112`` builds them (``add_node_table`` /
``add_edge_table``, and ``add_node_set`` for a masked split, which the JAX
package registers while it loads a masked source, ``graph.py:117-126``),
with the direct APIs of ``:246-287`` (decoders, topology, degrees, node
and edge lookups).  Loading sources from files (``node()``, ``edge()``,
``init()``) needs the file part of ``core/ingest.py`` and is not yet
ported; ``core/ingest.py`` parses attribute strings in memory.

Timestamps: the JAX ``Graph.init`` calls ``unify_ts_bases`` once every
table is loaded (``graph.py:143-144``).  The port has no ``init``: tables
arrive one at a time, so ``add_edge_table`` calls it after each one, and
the store is in one time domain whenever a caller can reach it.  An
undirected edge type is ``add_edge_table(table, directed=False)``
(``Graph.edge(directed=False)``, ``graph.py:72-98``): within one node type
the table holds its edges and then their swapped copies, with every
payload repeated in the same order, as the JAX package loads the reversed
source into the type itself; between two node types it is the table and
its ``add_reverse_edge_table``.

A ``Graph`` owns the device its views live on: the CUDA card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from graph_learn_tpu_torch.core.schema import Decoder, Mask, mask_type
from graph_learn_tpu_torch.core.store import (EdgeTable, GraphStore, NodeSet,
                                              NodeTable, unify_ts_bases)
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device


class Graph:
    def __init__(self, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.store = GraphStore()

    # --- in-memory build ----------------------------------------------
    def add_node_table(self, table: NodeTable) -> "Graph":
        self.store.add_node_table(table)
        return self

    def add_edge_table(self, table: EdgeTable,
                       directed: bool = True) -> "Graph":
        """Register ``table``, then move every timestamped table of the
        store to one time base (``core/store.py unify_ts_bases``).  With
        ``directed=False`` the edges are traversable both ways: a table
        within one node type is registered as ``[edges; swapped edges]``
        (edge ids ``n..2n-1`` the swapped copies), a table between two
        node types gets its ``<type>_reverse`` table."""
        if not directed and table.src_type == table.dst_type:
            table = _with_swapped_copy(table)
        self.store.add_edge_table(table)
        unify_ts_bases(self.store)
        if not directed and table.src_type != table.dst_type:
            self.add_reverse_edge_table(table.type_name)
        return self

    def add_reverse_edge_table(self, edge_type: str) -> "Graph":
        """Make the bipartite ``edge_type`` undirected, as the JAX package's
        ``Graph.edge(..., directed=False)`` does: a ``<edge_type>_reverse``
        table of the same edges from dst to src (the same weights, labels,
        timestamps and features, in the same order).  Within one node type
        the JAX package appends the reversed edges to the type itself:
        ``add_edge_table(table, directed=False)``."""
        et = self.store.edge_table(edge_type)
        if et.src_type == et.dst_type:
            raise InvalidArgumentError(
                "add_reverse_edge_table: %r joins %r to itself; an "
                "undirected edge type within one node type is registered "
                "with add_edge_table(table, directed=False)"
                % (edge_type, et.src_type))
        return self.add_edge_table(EdgeTable(
            edge_type + "_reverse", et.dst_type, et.src_type, et.decoder,
            src=et.dst, dst=et.src, num_src_nodes=et.num_dst_nodes,
            num_dst_nodes=et.num_src_nodes, weights=et.weights,
            labels=et.labels, timestamps=_absolute_ts(et),
            **{f: getattr(et, f) for f in _EDGE_ATTRS}))

    def add_node_set(self, node_type: str, raw_ids: np.ndarray,
                     mask: Union[Mask, str], weights=None) -> "Graph":
        """Register the split ``mask`` of ``node_type``: the nodes of the
        given raw ids (each must be in the table), traversed by
        ``V(node_type, mask=mask)``."""
        typed = mask_type(node_type, mask)
        if typed == node_type:
            raise InvalidArgumentError("add_node_set needs a mask other "
                                       "than Mask.NONE")
        idx = self.store.node_table(node_type).index.lookup(raw_ids)
        self.store.add_node_set(NodeSet(
            type_name=typed, base_type=node_type, indices=idx,
            weights=None if weights is None else np.asarray(weights,
                                                            np.float32)))
        return self

    # --- decoders / topology ------------------------------------------
    def get_node_decoder(self, node_type: str) -> Decoder:
        """The decoder of ``node_type``'s table (an empty one when the
        store has no such table, as the JAX package answers)."""
        t = self.store.nodes.get(node_type)
        return t.decoder if t is not None else Decoder()

    def get_edge_decoder(self, edge_type: str) -> Decoder:
        t = self.store.edges.get(edge_type)
        return t.decoder if t is not None else Decoder()

    def topology(self) -> Dict[str, Tuple[str, str]]:
        """{edge type: (src node type, dst node type)}."""
        return dict(self.store.topology)

    # --- direct (non-GSL) APIs ----------------------------------------
    def get_stats(self) -> Dict[str, Dict[str, int]]:
        return self.store.stats()

    def out_degrees(self, node_ids: np.ndarray, edge_type: str) -> np.ndarray:
        et = self.store.edge_table(edge_type)
        idx = self.store.node_table(et.src_type).index.lookup(
            np.asarray(node_ids, np.int64))
        return et.out_degrees[idx]

    def in_degrees(self, node_ids: np.ndarray, edge_type: str) -> np.ndarray:
        et = self.store.edge_table(edge_type)
        idx = self.store.node_table(et.dst_type).index.lookup(
            np.asarray(node_ids, np.int64))
        return et.in_degrees[idx]

    def lookup_nodes(self, node_type: str, ids: np.ndarray):
        """Attributes of the given raw node ids, on the graph's device."""
        from graph_learn_tpu_torch.ops.lookup import lookup_nodes
        t = self.store.node_table(node_type)
        idx = t.index.lookup(np.asarray(ids, np.int64))
        return lookup_nodes(t.device(self.device),
                            torch.as_tensor(idx, device=self.device),
                            type_name=node_type)

    def lookup_edges(self, edge_type: str, edge_ids: np.ndarray) -> dict:
        """The payload of the given edge row indices (-1: a pad), on the
        graph's device: ``ops.lookup.edge_payload``."""
        from graph_learn_tpu_torch.ops.lookup import edge_payload
        et = self.store.edge_table(edge_type)
        return edge_payload(et.device(self.device),
                            torch.as_tensor(np.asarray(edge_ids, np.int32),
                                            device=self.device))

    # --- GSL entry point ----------------------------------------------
    def V(self, t: str, node_from=None,
          mask: Union[Mask, str, None] = Mask.NONE):
        from graph_learn_tpu_torch.gsl.query import v_entry
        return v_entry(self, t, node_from=node_from, mask=mask)

    def E(self, edge_type: str):
        from graph_learn_tpu_torch.gsl.query import e_entry
        return e_entry(self, edge_type)


# the attribute columns an edge table's reversed or swapped copy repeats
_EDGE_ATTRS = ("int_attrs", "float_attrs", "multival_attrs", "multival_lens")


def _absolute_ts(et: EdgeTable):
    """The table's timestamps in their own (not rebased) time domain."""
    return (None if et.timestamps is None
            else et.timestamps * et.ts_scale + et.ts_base)


def _with_swapped_copy(et: EdgeTable) -> EdgeTable:
    """``et`` followed by its edges from dst to src, each payload repeated
    in the same order (``graph.py _load_edge_type`` over the source and its
    reversed copy)."""
    def twice(a):
        return None if a is None else np.concatenate([a, a])
    return EdgeTable(
        et.type_name, et.src_type, et.dst_type, et.decoder,
        src=np.concatenate([et.src, et.dst]),
        dst=np.concatenate([et.dst, et.src]),
        num_src_nodes=et.num_src_nodes, num_dst_nodes=et.num_dst_nodes,
        weights=twice(et.weights), labels=twice(et.labels),
        timestamps=twice(_absolute_ts(et)),
        **{f: twice(getattr(et, f)) for f in _EDGE_ATTRS})


def synthetic_graph(n_nodes: int, avg_degree: int, feat_dim: int,
                    classes: int, seed: int = 0,
                    device: DeviceLike = "cuda") -> Tuple[Graph, Decoder]:
    """The benchmark's synthetic graph, built straight into the store.

    Draws the same numbers in the same order as ``bench.py``'s
    ``build_graph_inmem``: one "item" node type with ``feat_dim`` float
    features and labels, one weighted "rel" edge type with
    ``n_nodes * avg_degree`` uniformly random edges.
    """
    rng = np.random.default_rng(seed)
    n, d = n_nodes, feat_dim
    e = n * avg_degree
    node_dec = Decoder(labeled=True, attr_types=["float"] * d)
    edge_dec = Decoder(weighted=True)
    g = Graph(device=device)
    g.add_node_table(NodeTable(
        "item", node_dec, np.arange(n, dtype=np.int64),
        float_attrs=rng.standard_normal((n, d), np.float32),
        labels=rng.integers(0, classes, n).astype(np.int32)))
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    g.add_edge_table(EdgeTable(
        "rel", "item", "item", edge_dec, src=src, dst=dst,
        num_src_nodes=n, num_dst_nodes=n,
        weights=rng.random(e).astype(np.float32)))
    return g, node_dec
