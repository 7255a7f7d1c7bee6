"""Graph facade: in-memory table registration, lookups, the ``V()`` entry.

Counterpart of ``graph_learn_tpu/graph.py:47-321`` for tables built in
memory, as ``bench.py:84-112`` builds them (``add_node_table`` /
``add_edge_table``).  Loading sources from files (``node()``, ``edge()``,
``init()``) needs ``core/ingest.py`` and is not yet ported.

A ``Graph`` owns the device its views live on: the CUDA card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.store import EdgeTable, GraphStore, NodeTable
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device


class Graph:
    def __init__(self, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.store = GraphStore()

    # --- in-memory build ----------------------------------------------
    def add_node_table(self, table: NodeTable) -> "Graph":
        self.store.add_node_table(table)
        return self

    def add_edge_table(self, table: EdgeTable) -> "Graph":
        self.store.add_edge_table(table)
        return self

    # --- direct (non-GSL) APIs ----------------------------------------
    def get_stats(self) -> Dict[str, Dict[str, int]]:
        return self.store.stats()

    def out_degrees(self, node_ids: np.ndarray, edge_type: str) -> np.ndarray:
        et = self.store.edge_table(edge_type)
        idx = self.store.node_table(et.src_type).index.lookup(
            np.asarray(node_ids, np.int64))
        return et.out_degrees[idx]

    def lookup_nodes(self, node_type: str, ids: np.ndarray):
        """Attributes of the given raw node ids, on the graph's device."""
        from graph_learn_tpu_torch.ops.lookup import lookup_nodes
        t = self.store.node_table(node_type)
        idx = t.index.lookup(np.asarray(ids, np.int64))
        return lookup_nodes(t.device(self.device),
                            torch.as_tensor(idx, device=self.device),
                            type_name=node_type)

    # --- GSL entry point ----------------------------------------------
    def V(self, t: str):
        from graph_learn_tpu_torch.gsl.query import v_entry
        return v_entry(self, t)


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
