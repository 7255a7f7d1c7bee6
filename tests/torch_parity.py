"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

One numpy graph, made from a seed, is loaded into both packages: the JAX
reference (``graph_learn_tpu``) and the PyTorch port
(``graph_learn_tpu_torch``, on the CPU).  The layout is the benchmark's: one
"item" node type with float features and labels, one weighted "rel" edge
type, uniformly random edges.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np


def numpy_graph(n: int = 300, avg_degree: int = 6, d: int = 8,
                classes: int = 4, seed: int = 0,
                weighted: bool = True,
                isolated: int = 0) -> Dict[str, np.ndarray]:
    """Arrays of a random graph.  The last ``isolated`` nodes get no
    out-edges, so a test has zero-degree seeds."""
    rng = np.random.default_rng(seed)
    e = n * avg_degree
    src = rng.integers(0, n - isolated, e)
    dst = rng.integers(0, n, e)
    return {
        "raw_ids": np.arange(n, dtype=np.int64) * 3 + 7,  # not dense
        "feats": rng.standard_normal((n, d), np.float32),
        "labels": rng.integers(0, classes, n).astype(np.int32),
        "src": src, "dst": dst,
        "weights": rng.random(e).astype(np.float32) if weighted else None,
    }


def jax_graph(a: Dict[str, np.ndarray]):
    """The JAX package's Graph over ``a`` (built as bench.py builds it)."""
    from graph_learn_tpu.core.schema import Decoder
    from graph_learn_tpu.core.store import EdgeTable, NodeTable
    from graph_learn_tpu.graph import Graph

    n, d = a["feats"].shape
    node_dec = Decoder(labeled=True, attr_types=["float"] * d)
    edge_dec = Decoder(weighted=a["weights"] is not None)
    g = Graph()
    g.store.add_node_table(NodeTable("item", node_dec, a["raw_ids"],
                                     float_attrs=a["feats"],
                                     labels=a["labels"]))
    g.store.add_edge_table(EdgeTable("rel", "item", "item", edge_dec,
                                     src=a["src"], dst=a["dst"],
                                     num_src_nodes=n, num_dst_nodes=n,
                                     weights=a["weights"]))
    g._node_decoders["item"] = node_dec
    g._edge_decoders["rel"] = edge_dec
    g._initialized = True
    return g, node_dec


def torch_graph(a: Dict[str, np.ndarray]):
    """The port's Graph over ``a``, on the CPU."""
    import graph_learn_tpu_torch as glt

    n, d = a["feats"].shape
    node_dec = glt.Decoder(labeled=True, attr_types=["float"] * d)
    edge_dec = glt.Decoder(weighted=a["weights"] is not None)
    g = glt.Graph(device="cpu")
    g.add_node_table(glt.NodeTable("item", node_dec, a["raw_ids"],
                                   float_attrs=a["feats"],
                                   labels=a["labels"]))
    g.add_edge_table(glt.EdgeTable("rel", "item", "item", edge_dec,
                                   src=a["src"], dst=a["dst"],
                                   num_src_nodes=n, num_dst_nodes=n,
                                   weights=a["weights"]))
    return g, node_dec


def two_hop(g, k1: int, k2: int, batch: int = 64):
    """The benchmark's 2-hop query shape on either package's Graph."""
    return (g.V("item").batch(batch).alias("src")
            .outV("rel").sample(k1).by("random").alias("hop1")
            .outV("rel").sample(k2).by("random").alias("hop2").values())


@contextlib.contextmanager
def both_confs(**fields):
    """Set the same config fields in both packages, restore them after."""
    from graph_learn_tpu.config import conf as jconf
    from graph_learn_tpu_torch.config import conf as tconf
    old = [(c, k, getattr(c, k)) for c in (jconf, tconf) for k in fields]
    try:
        for c in (jconf, tconf):
            for k, v in fields.items():
                setattr(c, k, v)
        yield
    finally:
        for c, k, v in old:
            setattr(c, k, v)
