"""Host-side build of a graph store sharded over the mesh's "graph" axis.

Counterpart of ``graph_learn_tpu/parallel/sharded_store.py`` (the storage
half of the sampled-path distribution; the device half is
``core/sharding.py``).  Each node type's dense index space is
range-partitioned: rank ``g`` of the graph axis owns rows
``[g * rps, (g + 1) * rps)``.  Per edge type, a shard holds the CSR rows of
the nodes it owns (re-indexed locally, with GLOBAL neighbour and edge
ids) and one block of ``eps`` edge rows of every edge payload; only the
id-sized negative pools, the node-weight CDFs and the ``.where()``
condition tables are replicated.

The JAX package builds all P blocks on the host, stacked on a leading [P]
axis for ``shard_map``.  Here ``build_sharded_tables(..., shard=p)``
builds block ``p`` alone (the global padding, row counts and maximum
degree are read from the whole edge list, so the block is the one the
full build makes), and a rank places only its own block.  A block holds
the port's flat CSR arrays (``DeviceCSR``'s fields), each padded to the
edge count of the fullest block: the JAX block's ``*_tiled`` arrays
flattened, bit for bit.  The JAX layout's interleaved ``off_pairs`` (a
TPU gather layout) is the one array the port leaves out, so
:meth:`ShardedTables.bytes_per_device` is the JAX figure less those
bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.sharding import (GRAPH_AXIS, ShardedCSR,
                                                 ShardedEdgeTable,
                                                 ShardedNodeTable, mesh_axis)
from graph_learn_tpu_torch.core.store import (DeviceCSR, DeviceNodeTable,
                                              EdgeTable, NodeTable, _build_csr,
                                              _pool, _put)
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

_NODE_FIELDS = ("raw_ids", "int_attrs", "float_attrs", "multival_attrs",
                "multival_lens", "weights", "labels", "timestamps")
_CSR_FIELDS = ("nbr_ids", "nbr_edge_ids", "nbr_ids_sorted",
               "nbr_edge_ids_sorted", "cum_weights", "cum_in_degrees",
               "nbr_ts")


def _rps(n: int, p: int, slack: float = 1.0) -> int:
    """Rows per shard under range partition.  ``slack`` > 1 reserves tail
    capacity so appended rows land in existing padding; slacked
    capacities are quantised to 64 rows so small appends keep every
    block's shape and ownership map (``:42-54``)."""
    base = max(-(-int(n * slack) // p), 1)
    if slack > 1.0:
        base = -(-base // 64) * 64
    return base


def _pad_rows(a: Optional[np.ndarray], rows: int) -> Optional[np.ndarray]:
    if a is None:
        return None
    pad = rows - a.shape[0]
    if pad <= 0:
        return a
    return np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))


def _shards(p: int, shard: Optional[int]) -> Sequence[int]:
    return range(p) if shard is None else (shard,)


def _stack_node_table(nt: NodeTable, p: int, slack: float = 1.0,
                      shard: Optional[int] = None):
    """-> (blocks {field: [S, rps, ...]}, replicated, meta) for the shards
    built (all P, or ``shard`` alone)."""
    rps = _rps(nt.num_nodes, p, slack)
    fa = nt.float_attrs
    if fa is not None and conf.feature_dtype == "bfloat16":
        fa = torch.from_numpy(np.ascontiguousarray(fa)).to(torch.bfloat16)
    fields = {"raw_ids": nt.raw_ids, "int_attrs": nt.int_attrs,
              "float_attrs": fa, "multival_attrs": nt.multival_attrs,
              "multival_lens": nt.multival_lens, "weights": nt.weights,
              "labels": nt.labels, "timestamps": nt.timestamps}
    stacked = {}
    for name, arr in fields.items():
        if arr is None:
            continue
        if isinstance(arr, torch.Tensor):  # the bf16 features
            blocks = [torch.nn.functional.pad(
                arr[s * rps:(s + 1) * rps],
                (0, 0, 0, rps - arr[s * rps:(s + 1) * rps].shape[0]))
                for s in _shards(p, shard)]
            stacked[name] = torch.stack(blocks)
        else:
            stacked[name] = np.stack([_pad_rows(arr[s * rps:(s + 1) * rps],
                                                rps)
                                      for s in _shards(p, shard)])
    repl = {}
    if nt.weights is not None and nt.num_nodes:
        w = np.maximum(nt.weights.astype(np.float64), 0.0)
        total = w.sum()
        if total <= 0:
            w = np.ones_like(w)
            total = w.sum()
        repl["cum_weights"] = np.cumsum(w / total).astype(np.float32)
    return stacked, repl, {"rps": rps, "n_global": nt.num_nodes}


def _shard_csr_arrays(rows: np.ndarray, cols: np.ndarray, num_rows: int,
                      p: int, sort_key, sort_desc, weights, nbr_in_degrees,
                      timestamps, minimal: bool, slack: float = 1.0,
                      shard: Optional[int] = None):
    """Per-shard flat CSR arrays over a range partition of ``rows``
    (``:100-166``): neighbour and edge ids stay global, rows are local,
    every block padded to one edge count ``e_pad`` (the fullest block's,
    rounded up to 128, or 1024 with slack)."""
    rps = _rps(num_rows, p, slack)
    owner = rows // rps
    per_shard = np.bincount(owner, minlength=p)[:p] if rows.size else \
        np.zeros(p, np.int64)
    e_max = int(per_shard.max()) if p else 0
    degs = np.bincount(rows, minlength=1) if rows.size else np.zeros(1)
    maxdeg = int(degs.max()) if rows.size else 0
    _q = 1024 if slack > 1.0 else 128
    e_pad = -(-max(int(e_max * slack), 1) // _q) * _q
    blocks = {k: [] for k in ("row_offsets",) + _CSR_FIELDS}
    for s in _shards(p, shard):
        lo, hi = s * rps, (s + 1) * rps
        sel = np.nonzero((rows >= lo) & (rows < hi))[0]
        ro, nbr, eids, nbr_s, eid_s, cumw, cumind, nts = _build_csr(
            rows[sel] - lo, cols[sel], rps,
            None if sort_key is None else sort_key[sel], sort_desc,
            None if weights is None else weights[sel], nbr_in_degrees,
            full=True,
            timestamps=None if timestamps is None else timestamps[sel])
        # local edge ids -> global edge rows
        if sel.size:
            eids = sel[eids].astype(np.int32)
            eid_s = sel[eid_s].astype(np.int32)
        if minimal:
            nbr_s = eid_s = cumw = cumind = None
        else:  # an empty block still carries its (padding-only) arrays
            if cumw is None and weights is not None:
                cumw = np.zeros(0, np.float32)
            if cumind is None and nbr_in_degrees is not None:
                cumind = np.zeros(0, np.float32)
        if nts is None and timestamps is not None:
            nts = np.zeros(0, np.int32)
        blocks["row_offsets"].append(ro)
        for k, a in zip(_CSR_FIELDS, (nbr, eids, nbr_s, eid_s, cumw, cumind,
                                      nts)):
            blocks[k].append(None if a is None else np.concatenate(
                [a, np.zeros(e_pad - a.shape[0], a.dtype)]))
    stacked = {k: np.stack(v) for k, v in blocks.items()
               if v and v[0] is not None}
    return stacked, {"rps": rps, "n_edges": int(e_pad), "max_degree": maxdeg}


def _stack_edge_table(et: EdgeTable, p: int, minimal: bool,
                      slack: float = 1.0, shard: Optional[int] = None):
    src32 = et.src.astype(np.int32)
    dst32 = et.dst.astype(np.int32)
    out_arrs, out_meta = _shard_csr_arrays(
        et.src.astype(np.int64), dst32, et.num_src_nodes, p,
        et._sort_key, et._sort_desc, et.weights, et.in_degrees,
        et.timestamps, minimal, slack, shard)
    stacked = {"out": out_arrs}
    meta = {"out": out_meta}
    if not minimal:
        inc_arrs, inc_meta = _shard_csr_arrays(
            et.dst.astype(np.int64), src32, et.num_dst_nodes, p,
            et._sort_key, et._sort_desc, et.weights, et.out_degrees,
            et.timestamps, minimal, slack, shard)
        stacked["inc"] = inc_arrs
        meta["inc"] = inc_meta
    eps = _rps(et.num_edges, p, slack)
    fields = {"src": src32, "dst": dst32, "weights": et.weights,
              "labels": et.labels,
              "timestamps": None if et.timestamps is None
              else et.timestamps.astype(np.int32),
              "int_attrs": et.int_attrs, "float_attrs": et.float_attrs,
              "multival_attrs": et.multival_attrs,
              "multival_lens": et.multival_lens}
    for name, arr in fields.items():
        if arr is None:
            continue
        stacked[name] = np.stack([_pad_rows(arr[s * eps:(s + 1) * eps], eps)
                                  for s in _shards(p, shard)])
    repl = {}
    if not minimal:
        repl["unique_dst"], repl["unique_dst_indeg_cdf"] = _pool(
            dst32, et.in_degrees)
        repl["unique_src"], repl["unique_src_outdeg_cdf"] = _pool(
            src32, et.out_degrees)
    meta["eps"] = eps
    meta["num_edges"] = et.num_edges
    return stacked, repl, meta


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (np.ndarray, torch.Tensor)):
        yield tree


def _nbytes(a) -> int:
    return (a.numel() * a.element_size() if isinstance(a, torch.Tensor)
            else a.nbytes)


def _to(a, dev: torch.device) -> torch.Tensor:
    return a.to(dev) if isinstance(a, torch.Tensor) else _put(a, dev)


def same_leaf(a, b) -> bool:
    """Equal shape, dtype and values (two host arrays, or two tensors)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and (torch.equal(a, b) if isinstance(a, torch.Tensor)
                 else np.array_equal(a, b)))


def _to_device(x, dev: torch.device):
    """``x`` (tensors inside dicts and dataclasses) moved to ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to_device(v, dev) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _to_device(getattr(x, f.name), dev)
            for f in dataclasses.fields(x) if f.init})
    return x


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@dataclasses.dataclass
class ShardedTables:
    """Host blocks of the shards built (``stacked``: every leaf has a
    leading axis over ``shards``), replicated host arrays (``repl``) and
    static metadata; :meth:`place` puts one rank's block and the
    replicated arrays on its device, and :meth:`view` turns the placed
    arrays into the tables dict the plan (``gsl/compile.py _execute``)
    reads."""

    stacked: Dict
    repl: Dict
    meta: Dict
    num_shards: int
    shards: tuple = ()
    axis: str = GRAPH_AXIS
    query: object = None
    # set by place(): this rank's shard and its device arrays
    shard: Optional[int] = None
    placed: Optional[Dict] = None
    placed_repl: Optional[Dict] = None
    device: Optional[torch.device] = None

    def block(self, p: int) -> Dict:
        """Shard ``p``'s host arrays (the leading axis dropped)."""
        i = list(self.shards).index(p)
        return _tree_map(lambda a: a[i], self.stacked)

    def bytes_per_device(self) -> int:
        """Host bytes of one block plus the replicated arrays.  The
        ``.where()`` condition tables are left out (the JAX package counts
        them among its replicated leaves)."""
        st = sum(_nbytes(a) for a in _leaves(self.stacked))
        rp = sum(_nbytes(a) for k, v in self.repl.items() if k != "cond"
                 for a in _leaves(v))
        return st // len(self.shards) + rp

    def place(self, mesh=None, device: Optional[DeviceLike] = None,
              shard: Optional[int] = None) -> "ShardedTables":
        """Put this rank's block (its index on the mesh's graph axis, or
        ``shard``) and the replicated arrays on ``device`` (default: the
        rank's device from ``init_cluster`` / ``spawn``, else the CPU);
        the host blocks stay for :meth:`replace_blocks`."""
        from graph_learn_tpu_torch.parallel import bootstrap

        if shard is None:
            shard = (mesh_axis(mesh, self.axis).index if mesh is not None
                     else self.shards[0])
        if device is None:
            device = bootstrap.current_device() or "cpu"
        dev = resolve_device(device)
        host = self.block(shard)
        placed = _tree_map(lambda a: _to(a, dev), host)
        return dataclasses.replace(self, shard=shard, placed=placed,
                                   placed_repl=self._place_repl(dev),
                                   device=dev)

    def _place_repl(self, dev: torch.device) -> Dict:
        """The replicated arrays on ``dev``, and the ``.where()`` condition
        tables: ``repl["cond"]`` where the host tables carry them (a
        serving follower gets its leader's), else built from the query's
        store."""
        from graph_learn_tpu_torch.gsl.compile import build_condition_tables
        repl = {k: _tree_map(lambda a: _to(a, dev), v)
                for k, v in self.repl.items() if k != "cond"}
        if "cond" in self.repl:
            repl["cond"] = _to_device(self.repl["cond"], dev)
        else:
            repl["cond"] = (build_condition_tables(self.query, dev)
                            if self.query is not None else {})
        return repl

    def view(self) -> Dict:
        """The placed block as the plan's tables dict: ``ShardedNodeTable``
        / ``ShardedEdgeTable`` over this rank's rows."""
        if self.placed is None:
            raise RuntimeError("view() needs a placed ShardedTables")
        blk, repl = self.placed, self.placed_repl
        out = {"nodes": {}, "edges": {}, "cond": repl.get("cond", {})}
        for t, fields in blk["nodes"].items():
            m = self.meta["nodes"][t]
            out["nodes"][t] = ShardedNodeTable(
                local=DeviceNodeTable(**{f: fields.get(f)
                                         for f in _NODE_FIELDS}),
                cum_weights=repl["nodes"][t].get("cum_weights"),
                rows_per_shard=m["rps"], num_nodes_global=m["n_global"],
                axis=self.axis)
        for t, fields in blk["edges"].items():
            m = self.meta["edges"][t]

            def csr(d, mm):
                return ShardedCSR(
                    local=DeviceCSR(row_offsets=d["row_offsets"],
                                    max_degree=mm["max_degree"],
                                    **{f: d.get(f) for f in _CSR_FIELDS}),
                    rows_per_shard=mm["rps"], axis=self.axis)

            r = repl["edges"][t]
            out["edges"][t] = ShardedEdgeTable(
                out=csr(fields["out"], m["out"]),
                inc=csr(fields["inc"], m["inc"]) if "inc" in fields else None,
                src=fields["src"], dst=fields["dst"],
                **{f: fields.get(f) for f in (
                    "weights", "labels", "timestamps", "int_attrs",
                    "float_attrs", "multival_attrs", "multival_lens")},
                **{f: r.get(f) for f in (
                    "unique_dst", "unique_dst_indeg_cdf", "unique_src",
                    "unique_src_outdeg_cdf")},
                edges_per_shard=m["eps"], num_edges_global=m["num_edges"],
                axis=self.axis)
        return out

    def device_bytes(self) -> int:
        """Bytes of the placed block and replicated arrays on the device."""
        return sum(_nbytes(a) for a in _leaves(self.placed)) + sum(
            _nbytes(a) for k, v in self.placed_repl.items() if k != "cond"
            for a in _leaves(v))

    def replace_blocks(self, new: "ShardedTables"):
        """Incremental refresh of this rank's block (``:271-341``): for
        every leaf whose shape and dtype are unchanged, the block is
        compared on the host and the device array of an unchanged block is
        kept; a changed block, or a leaf whose layout moved, is uploaded.
        The replicated arrays are uploaded whole.  Returns ``(placed_new,
        uploaded_bytes)``; summed over the ranks of the axis, the block
        bytes are the JAX package's (which counts every shard's block and
        the replicated arrays once)."""
        if self.placed is None:
            raise RuntimeError("replace_blocks requires a placed "
                               "ShardedTables")
        dev = self.device
        uploaded = [0]
        old_host = self.block(self.shard)
        new_host = new.block(self.shard)

        def merge(old_dev, old_h, new_h):
            if isinstance(new_h, dict):
                return {k: merge((old_dev or {}).get(k), (old_h or {}).get(k),
                                 v) for k, v in new_h.items()}
            if (old_dev is not None and old_h is not None
                    and same_leaf(old_h, new_h)):
                return old_dev
            uploaded[0] += _nbytes(new_h)
            return _to(new_h, dev)

        placed = merge(self.placed, old_host, new_host)
        uploaded[0] += sum(_nbytes(a) for k, v in new.repl.items()
                           if k != "cond" for a in _leaves(v))
        return dataclasses.replace(new, shard=self.shard, placed=placed,
                                   placed_repl=new._place_repl(dev),
                                   device=dev), uploaded[0]


def _query_types(query):
    """(node types, edge types) the query's plan touches."""
    store = query.graph.store
    node_types, edge_types = set(), set()
    for n in query.dag.nodes:
        if n.edge_type:
            edge_types.add(n.edge_type)
            s, d = store.topology[n.edge_type]
            node_types.update((s, d))
        if n.node_type:
            ns = store.node_sets.get(n.node_type)
            node_types.add(ns.base_type if ns else n.node_type)
    return node_types, edge_types


def estimate_query_table_bytes(query) -> int:
    """Host estimate of the device bytes the query's tables need
    (``:365-389``): DistTrainer partitions the store above a threshold."""
    store = query.graph.store
    node_types, edge_types = _query_types(query)
    total = 0
    for t in node_types:
        nt = store.node_table(t)
        for f in _NODE_FIELDS:
            a = getattr(nt, f, None)
            total += a.nbytes if a is not None else 0
    for t in edge_types:
        et = store.edge_table(t)
        for f in ("src", "dst", "weights", "labels", "timestamps",
                  "int_attrs", "float_attrs", "multival_attrs",
                  "multival_lens"):
            a = getattr(et, f, None)
            total += a.nbytes if a is not None else 0
        total += 2 * et.src.nbytes  # the CSR of both directions
    return total


def build_sharded_tables(query, num_shards: int,
                         profile: Optional[str] = None, slack: float = 1.0,
                         shard: Optional[int] = None) -> ShardedTables:
    """Shard every table the query touches over ``num_shards``: all the
    blocks, or block ``shard`` alone.  ``slack`` > 1 reserves per-shard
    tail capacity (the serving tier's incremental refresh)."""
    minimal = (profile or conf.storage_profile) == "minimal"
    store = query.graph.store
    node_types, edge_types = _query_types(query)
    stacked = {"nodes": {}, "edges": {}}
    repl = {"nodes": {}, "edges": {}}
    meta = {"nodes": {}, "edges": {}}
    for t in sorted(node_types):
        s, r, m = _stack_node_table(store.node_table(t), num_shards, slack,
                                    shard)
        stacked["nodes"][t], repl["nodes"][t], meta["nodes"][t] = s, r, m
    for t in sorted(edge_types):
        s, r, m = _stack_edge_table(store.edge_table(t), num_shards, minimal,
                                    slack, shard)
        stacked["edges"][t], repl["edges"][t], meta["edges"][t] = s, r, m
    return ShardedTables(stacked=stacked, repl=repl, meta=meta,
                         num_shards=num_shards,
                         shards=tuple(_shards(num_shards, shard)),
                         query=query)
