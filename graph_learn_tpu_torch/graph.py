"""Graph facade: sources loaded from files or tables built in memory,
lookups, k-NN search, the ``V()`` and ``E()`` entries.

Counterpart of ``graph_learn_tpu/graph.py:28-321``.  ``node()`` and
``edge()`` register file sources (``_NodeSource`` / ``_EdgeSource``,
``:28-98``: comma-separated paths, the reversed copies of an undirected
edge source) and ``init()`` loads them (``:101-216``): the base node
tables first, a repeated ``node()`` of one type merged into its table
(``_add_or_extend_node:148``), then the masked node sets resolved into
their base tables (``:117-126``), then the edge sources grouped by type
in the order they were registered (``_load_edge_type:181``), then one
``unify_ts_bases`` over the store (``:143-144``).  Parsing is
``core/ingest.py``'s.

The port also keeps an in-memory build, as ``bench.py:84-112`` builds
its tables: ``add_node_table`` / ``add_edge_table`` and ``add_node_set``
for a masked split.  Tables arrive one at a time there, so
``add_edge_table`` calls ``unify_ts_bases`` after each one, and the store
is in one time domain whenever a caller can reach it.  An undirected
edge type is ``add_edge_table(table, directed=False)``: within one node
type the table holds its edges and then their swapped copies, with every
payload repeated in the same order, as ``init()`` loads an undirected
source's reversed copy into the type itself; between two node types it
is the table and its ``add_reverse_edge_table``.  The two builds give the
same store for the same edges.  ``init()`` follows the registered sources
as the JAX package does, so a type with directed and undirected sources
gets the reversed copies of the undirected ones only.

The direct APIs of ``:246-287`` (decoders, topology, degrees, node and
edge lookups) and ``search`` (``:288-310``, k-NN over a node type's float
attributes, ``ops/knn.py``) are here; the sampler factories
(``node_sampler`` ... ``random_walk_sampler``) are attached by
``sampler_api.py`` when the package is imported.  ``init(reorder="bfs")``
relabels the nodes after the edges are loaded and before the time bases
are unified (``:133-145``, ``core/reorder.py``).  ``save`` / ``load``
(``:221-244``, ``core/snapshot.py``) write and restore the built store in
the JAX package's format.  ``search(mesh=...)`` range-partitions the
index over the mesh's "graph" axis (``ops/knn.py ShardedIndex``).

A ``Graph`` owns the device its views live on: the CUDA card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from graph_learn_tpu_torch.core import ingest
from graph_learn_tpu_torch.core.reorder import (REORDER_STRATEGIES,
                                                reorder_store)
from graph_learn_tpu_torch.core.schema import Decoder, Mask, mask_type
from graph_learn_tpu_torch.core.snapshot import load_store, save_store
from graph_learn_tpu_torch.core.store import (EdgeTable, GraphStore, NodeSet,
                                              NodeTable, unify_ts_bases)
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device


class _NodeSource:
    def __init__(self, path: str, node_type: str, decoder: Decoder,
                 mask: Mask):
        self.path = path
        self.node_type = node_type  # the base type
        self.decoder = decoder
        self.mask = mask


class _EdgeSource:
    def __init__(self, path: str, src_type: str, dst_type: str,
                 edge_type: str, decoder: Decoder, reversed_: bool = False):
        self.path = path
        self.src_type = src_type
        self.dst_type = dst_type
        self.edge_type = edge_type
        self.decoder = decoder
        self.reversed = reversed_


def _paths(source: str) -> List[str]:
    return [s.strip() for s in source.split(",")]


class Graph:
    def __init__(self, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.store = GraphStore()
        self._node_sources: List[_NodeSource] = []
        self._edge_sources: List[_EdgeSource] = []
        self._decoders: Dict[str, Decoder] = {}
        self._knn_indexes: Dict[tuple, object] = {}
        self._initialized = False

    # --- file sources (graph.py:47-98) --------------------------------
    def node(self, source: str, node_type: str, decoder: Decoder,
             mask: Union[Mask, str, None] = Mask.NONE) -> "Graph":
        """Register the node table file(s) ``source`` (comma-separated) of
        ``node_type``; with a ``mask`` the file lists the ids of that split
        of the type's table."""
        if not isinstance(decoder, Decoder):
            raise InvalidArgumentError("decoder must be a Decoder")
        mask = (Mask[mask.upper()] if isinstance(mask, str)
                else (mask or Mask.NONE))
        self._decoders[mask_type(node_type, mask)] = decoder
        for path in _paths(source):
            self._node_sources.append(_NodeSource(path, node_type, decoder,
                                                  mask))
        return self

    def edge(self, source: str, edge_type: Tuple[str, str, str],
             decoder: Optional[Decoder] = None,
             directed: bool = True) -> "Graph":
        """Register the edge table file(s) ``source`` of ``edge_type`` =
        (src type, dst type, edge type).  ``directed=False`` also loads
        each file reversed: into the type itself within one node type, as
        ``<edge type>_reverse`` between two."""
        if not (isinstance(edge_type, tuple) and len(edge_type) == 3):
            raise InvalidArgumentError(
                "edge_type must be (src_type, dst_type, edge_type)")
        decoder = decoder or Decoder()
        src_t, dst_t, e_t = edge_type
        self._decoders[e_t] = decoder
        paths = _paths(source)
        for path in paths:
            self._edge_sources.append(_EdgeSource(path, src_t, dst_t, e_t,
                                                  decoder))
        if not directed:
            rev_t = e_t if src_t == dst_t else e_t + "_reverse"
            self._decoders[rev_t] = decoder
            for path in paths:
                self._edge_sources.append(_EdgeSource(
                    path, dst_t, src_t, rev_t, decoder, reversed_=True))
        return self

    def init(self, **kwargs) -> "Graph":
        """Load every registered source into the store (once);
        ``reorder="bfs"`` relabels each node type with edges within itself
        before the time bases are unified (``core/reorder.py``); another
        strategy raises before anything is loaded."""
        reorder = kwargs.get("reorder")
        if reorder and reorder not in REORDER_STRATEGIES:
            raise ValueError("unknown reorder strategy %r" % reorder)
        if self._initialized:
            return self
        for ns in self._node_sources:
            if ns.mask == Mask.NONE:
                self._add_or_extend_node(
                    ns.node_type, ns.decoder,
                    ingest.load_node_table(ns.path, ns.decoder))
        for ns in self._node_sources:
            if ns.mask != Mask.NONE:
                cols = ingest.load_node_table(ns.path, ns.decoder)
                base = self.store.node_table(ns.node_type)
                self.store.add_node_set(NodeSet(
                    type_name=mask_type(ns.node_type, ns.mask),
                    base_type=ns.node_type,
                    indices=base.index.lookup(cols["ids"]),
                    weights=cols["weights"]))
        grouped: Dict[str, List[_EdgeSource]] = {}
        for es in self._edge_sources:
            grouped.setdefault(es.edge_type, []).append(es)
        for sources in grouped.values():
            self._load_edge_type(sources)
        if reorder:
            reorder_store(self.store, reorder)
        unify_ts_bases(self.store)
        self._initialized = True
        return self

    def _add_or_extend_node(self, node_type: str, decoder: Decoder, cols):
        """Create the node table, or append a further source's rows to it
        (a duplicate id across sources raises)."""
        if node_type in self.store.nodes:
            old = self.store.nodes[node_type]
            merged = {"ids": np.concatenate([old.raw_ids, cols["ids"]])}
            for f in _PAYLOAD:
                a, b = getattr(old, f), cols[f]
                if (a is None) != (b is None):
                    raise InvalidArgumentError(
                        "source schemas for node type %r disagree on %s "
                        "(all sources of one type must share the decoder "
                        "layout)" % (node_type, f))
                merged[f] = None if a is None else np.concatenate([a, b])
            cols = merged
        self.store.add_node_table(NodeTable(
            node_type, decoder, cols["ids"],
            **{f: cols[f] for f in _PAYLOAD}))

    def _load_edge_type(self, sources: List[_EdgeSource]):
        """One edge table from every source of its type, in order (a
        reversed source with its ids swapped); a raw id missing from its
        node table raises NotFoundError."""
        first = sources[0]
        src_parts, dst_parts = [], []
        payload: Dict[str, List[np.ndarray]] = {}
        for es in sources:
            cols = ingest.load_edge_table(es.path, es.decoder)
            s_ids, d_ids = cols["src_ids"], cols["dst_ids"]
            if es.reversed:
                s_ids, d_ids = d_ids, s_ids
            src_parts.append(s_ids)
            dst_parts.append(d_ids)
            for f in _PAYLOAD:
                if cols[f] is not None:
                    payload.setdefault(f, []).append(cols[f])
        src_table = self.store.node_table(first.src_type)
        dst_table = self.store.node_table(first.dst_type)
        self.store.add_edge_table(EdgeTable(
            first.edge_type, first.src_type, first.dst_type, first.decoder,
            src=src_table.index.lookup(np.concatenate(src_parts)),
            dst=dst_table.index.lookup(np.concatenate(dst_parts)),
            num_src_nodes=src_table.num_nodes,
            num_dst_nodes=dst_table.num_nodes,
            **{f: np.concatenate(v) for f, v in payload.items()}))

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

    # --- snapshots (graph.py:221-244) -----------------------------------
    def save(self, path: str) -> "Graph":
        """Write the built store to ``path/`` (``core/snapshot.py``); a
        later :meth:`load` restores it without the source files.  A graph
        built in memory can be saved at any time; one with file sources
        only after ``init()``, as the JAX package requires."""
        if (self._node_sources or self._edge_sources) and \
                not self._initialized:
            raise InvalidArgumentError("save() requires an initialized graph")
        save_store(self.store, path)
        return self

    @classmethod
    def load(cls, path: str, mmap: bool = True,
             device: DeviceLike = "cuda") -> "Graph":
        """A graph whose store is the snapshot at ``path`` (either
        package's), its arrays memory-mapped unless ``mmap=False``; its
        device views are built on ``device`` when first used."""
        g = cls(device=device)
        g.store = load_store(path, mmap=mmap)
        g._initialized = True
        return g

    # --- decoders / topology ------------------------------------------
    def get_node_decoder(self, node_type: str) -> Decoder:
        """The decoder registered for ``node_type`` (a masked type too) or
        of its table (an empty one when there is neither, as the JAX
        package answers)."""
        t = self.store.nodes.get(node_type)
        return self._decoders.get(
            node_type, t.decoder if t is not None else Decoder())

    def get_edge_decoder(self, edge_type: str) -> Decoder:
        t = self.store.edges.get(edge_type)
        return self._decoders.get(
            edge_type, t.decoder if t is not None else Decoder())

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

    # --- k-NN (graph.py:288-310) -----------------------------------------
    def search(self, node_type: str, inputs: np.ndarray, option, mesh=None):
        """The ``option.k`` nearest rows of ``node_type``'s float
        attributes to each row of ``inputs``: (ids [m, k] raw node ids, -1
        padded; distances [m, k]), numpy.  The index is built on the
        graph's device at the first call and kept per (node type, index
        type), as the JAX package keys it: a later call with another
        ``nlist``, ``nprobe`` or ``metric`` searches the index built
        first.  With a ``mesh`` whose "graph" axis has more than one rank,
        every rank of that axis calls it with the same inputs: the index,
        trained on the axis's first rank and added on each, is
        range-partitioned over the axis (``knn.shard_index``) and kept
        under its own key; the answer is the unsharded one."""
        from graph_learn_tpu_torch.ops import knn
        sharded = (mesh is not None and "graph" in mesh.mesh_dim_names
                   and mesh.size(mesh.mesh_dim_names.index("graph")) > 1)
        key = (node_type, option.index_type, sharded)
        if key not in self._knn_indexes:
            t = self.store.node_table(node_type)
            if t.float_attrs is None:
                raise InvalidArgumentError(
                    "node type %r has no float attrs for KNN" % node_type)
            index = knn.build_index(t.float_attrs, t.raw_ids, option,
                                    device=self.device,
                                    mesh=mesh if sharded else None)
            if sharded:
                index = knn.shard_index(index, mesh)
            self._knn_indexes[key] = index
        return self._knn_indexes[key].search(np.asarray(inputs, np.float32),
                                             option.k)

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
# the payload columns of a loaded table, in the order they are merged
_PAYLOAD = _EDGE_ATTRS + ("weights", "labels", "timestamps")


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
