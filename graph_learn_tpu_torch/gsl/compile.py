"""GSL query -> eager device plan.

Counterpart of ``graph_learn_tpu/gsl/compile.py`` ``Query:51``,
``source_space:69``, ``device_tables:77``, ``_execute:156``, and of the
``source_v``, ``source_e`` and ``endpoint_*`` branches of
``_exec_node:172``, ``_exec_hop:249`` (``out_v`` / ``in_v`` / ``out_e`` /
``in_e`` for every non-temporal strategy; ``full`` returns ``SparseNodes``,
on an edge hop too, as in the JAX package) and ``_exec_neg:372`` without
its conditional branch, with ``.filter()`` and registered strategies.
PyTorch runs eagerly, so there is no jit: ``_execute`` walks the DAG once
per call.  Each hop's feature rows stay deferred (ops/lookup.py) until a
reader gathers or reduces them.  Randomness comes from one explicit
``torch.Generator``, drawn from in DAG order (the JAX package splits one
key per node; the two streams differ, see ops/sampling.py).  No
timestamped table can be built yet (``Decoder`` refuses one), so no record
carries the JAX package's per-element timestamps.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.values import Edges, Nodes
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.gsl.dag import Dag, DagNode
from graph_learn_tpu_torch.ops import negative as neg_ops
from graph_learn_tpu_torch.ops import sampling as samp_ops
from graph_learn_tpu_torch.ops.lookup import (edge_field, edge_payload,
                                              lookup_nodes,
                                              lookup_sparse_nodes)
from graph_learn_tpu_torch.ops.segment import row_bounds
from graph_learn_tpu_torch.utils.platform import DeviceLike


class _Rec:
    """Per-node execution record inside the plan: the node's dense ids and
    its value (``Nodes``, ``SparseNodes`` or ``Edges``)."""

    __slots__ = ("ids", "value")

    def __init__(self, ids, value):
        self.ids = ids
        self.value = value


class Query:
    """A finished GSL query: runs the plan on the graph's device tables."""

    def __init__(self, dag: Dag, post_func=None):
        self.dag = dag
        self.graph = dag.graph
        self.post_func = post_func
        src = dag.nodes[0]
        if src.kind not in ("source_v", "source_e"):
            raise InvalidArgumentError("query must start at V()/E()")
        self.source = src

    def source_space(self):
        """(size, kind) of the seed space: (the node set's size, "node")
        for ``V()``, (the edge type's edge count, "edge") for ``E()``."""
        if self.source.kind == "source_v":
            return self.graph.store.node_set(self.source.node_type).size, \
                "node"
        return self.graph.store.edge_table(self.source.edge_type).num_edges, \
            "edge"

    def seed_indices(self):
        """The [M] dense node indices a ``V()`` epoch walks, or None for an
        ``E()`` source, whose positions are its edge ids."""
        if self.source.kind == "source_e":
            return None
        return self.graph.store.node_set(self.source.node_type).indices

    def device_tables(self, device: Optional[DeviceLike] = None):
        """The node and edge tables the plan reads, on ``device`` (default:
        the graph's device)."""
        device = self.graph.device if device is None else device
        store = self.graph.store
        node_types, edge_types = set(), set()
        for n in self.dag.nodes:
            if n.edge_type:
                edge_types.add(n.edge_type)
                node_types.update(store.topology[n.edge_type])
            if n.node_type:
                node_types.add(store.node_set(n.node_type).base_type)
        return {
            "nodes": {t: store.node_table(t).device(device)
                      for t in node_types},
            "edges": {t: store.edge_table(t).device(device)
                      for t in edge_types},
        }

    def run(self, seeds: torch.Tensor, generator: torch.Generator):
        return _execute(self, self.device_tables(), seeds, generator)


def _execute(query: Query, tables, seeds: torch.Tensor,
             generator: torch.Generator) -> Dict[str, object]:
    """seeds [b] dense indices (node or edge rows) -> {alias: value}."""
    recs: Dict[int, _Rec] = {}
    for node in query.dag.nodes:
        recs[node.nid] = _exec_node(query, tables, node, recs, seeds,
                                    generator)
    return {alias: recs[node.nid].value
            for alias, node in query.dag.aliased_nodes.items()}


def _exec_node(query: Query, tables, node: DagNode, recs, seeds,
               generator) -> _Rec:
    kind = node.kind
    if kind == "source_v":
        base = query.graph.store.node_set(node.node_type).base_type
        ids = seeds.to(torch.int32)
        val = lookup_nodes(tables["nodes"][base], ids, type_name=node.node_type)
        return _Rec(ids, val)
    if kind == "source_e":
        et = tables["edges"][node.edge_type]
        s_t, d_t = query.graph.store.topology[node.edge_type]
        eidx = seeds.to(torch.int32)
        src_ids = edge_field(et, "src", eidx)
        pay = edge_payload(et, eidx)
        val = Edges(
            edge_ids=eidx,
            src_nodes=lookup_nodes(tables["nodes"][s_t], src_ids,
                                   type_name=s_t),
            dst_nodes=lookup_nodes(tables["nodes"][d_t],
                                   edge_field(et, "dst", eidx),
                                   type_name=d_t),
            weights=pay["weights"], labels=pay["labels"],
            type_name=node.edge_type)
        return _Rec(src_ids, val)
    parent = recs[node.parent.nid]
    if kind in ("endpoint_src", "endpoint_dst"):
        ev = parent.value
        nv = ev.src_nodes if kind == "endpoint_src" else ev.dst_nodes
        return _Rec(nv.ids, nv)
    if kind in ("out_v", "in_v", "out_e", "in_e"):
        return _exec_hop(query, tables, node, parent, recs, generator)
    if kind in ("out_neg", "in_neg"):
        return _exec_neg(query, tables, node, parent, generator)
    raise InvalidArgumentError("dag node kind %r is not yet ported" % kind)


def _exec_hop(query: Query, tables, node: DagNode, parent: _Rec, recs,
              generator):
    et = tables["edges"][node.edge_type]
    s_t, d_t = query.graph.store.topology[node.edge_type]
    incoming = node.kind in ("in_v", "in_e")
    csr = et.inc if incoming else et.out
    if csr is None:
        raise InvalidArgumentError(
            "%s(%r) needs the reverse CSR, which conf.storage_profile="
            "'minimal' leaves off the device"
            % ("inV" if node.kind == "in_v" else "inE", node.edge_type))
    result_type = s_t if incoming else d_t
    shape = tuple(parent.ids.shape)
    flat = parent.ids.reshape(-1)

    # the parent's degrees w.r.t. the hopped edge type (reference
    # DegreeDagNode): Nodes.out_degrees on dense hops
    pv = parent.value
    if isinstance(pv, Nodes) and pv.out_degrees is None:
        _, _, deg = row_bounds(csr.row_offsets, flat)
        parent.value = pv.replace(out_degrees=deg.reshape(shape))

    k = node.count
    strategy = node.strategy
    nt = tables["nodes"][result_type]
    flt = None
    if node.filter_alias is not None:
        # reject samples equal to the target's ids in the same row
        # (reference FilterType.EQUAL on FilterField.ID, applied inside
        # every built-in sampler)
        target = query.dag.get_node(node.filter_alias)
        excl = recs[target.nid].ids.reshape(-1)
        if excl.shape != flat.shape:
            raise InvalidArgumentError(
                ".filter(%r): the target has %d ids for the hop's %d rows"
                % (node.filter_alias, excl.numel(), flat.numel()))
        flt = samp_ops.SampleFilter(exclude_dst=excl)
    if strategy == "full":
        # SparseNodes on an edge hop too, as the JAX package answers it
        cap = k if k > 0 else conf.default_full_nbr_num
        ids, _, degs = samp_ops.full_sample(csr, flat, cap, flt=flt)
        val = lookup_sparse_nodes(nt, ids, degs, type_name=result_type)
        return _Rec(ids.reshape(shape + (cap,)), val)
    if strategy in ("edge_weight", "in_degree"):
        ids, eids = samp_ops.weighted_sample(csr, flat, k, generator,
                                             by=strategy, flt=flt)
    elif strategy in samp_ops.BUILTIN_STRATEGIES:
        ids, eids = samp_ops.STRATEGY_FNS[strategy](csr, flat, k, generator,
                                                    flt=flt)
    elif strategy in samp_ops.STRATEGY_FNS:
        # a registered strategy (register_sampler); filters do not reach
        # it, as in the JAX package
        ids, eids = samp_ops.STRATEGY_FNS[strategy](csr, flat, k, generator)
    else:
        raise InvalidArgumentError("unknown strategy %r" % strategy)
    ids = ids.reshape(shape + (k,))
    if node.kind in ("out_v", "in_v"):
        return _Rec(ids, lookup_nodes(nt, ids, type_name=result_type))
    # edge hop: Edges whose src view repeats the parent's id in every slot
    eids = eids.reshape(shape + (k,))
    src_type = d_t if incoming else s_t
    pay = edge_payload(et, eids)
    val = Edges(
        edge_ids=eids,
        src_nodes=lookup_nodes(tables["nodes"][src_type],
                               parent.ids[..., None].expand(ids.shape),
                               type_name=src_type),
        dst_nodes=lookup_nodes(nt, ids, type_name=result_type),
        weights=pay["weights"], labels=pay["labels"],
        type_name=node.edge_type)
    return _Rec(ids, val)


def _exec_neg(query: Query, tables, node: DagNode, parent: _Rec, generator):
    shape = tuple(parent.ids.shape)
    flat = parent.ids.reshape(-1)
    if node.edge_type is None:
        # Neg(node_type): the pool is the node set's base table
        base = query.graph.store.node_set(node.node_type).base_type
        nt = tables["nodes"][base]
        ids = neg_ops.negative_sample_from_nodes(
            nt, flat.shape[0], node.count, generator, strategy=node.strategy)
        ids = ids.reshape(shape + (node.count,))
        return _Rec(ids, lookup_nodes(nt, ids, type_name=base))
    et = tables["edges"][node.edge_type]
    s_t, d_t = query.graph.store.topology[node.edge_type]
    reverse = node.kind == "in_neg"
    result_type = s_t if reverse else d_t
    nt = tables["nodes"][result_type]
    ids = neg_ops.negative_sample(et, flat, node.count, generator,
                                  strategy=node.strategy, dst_table=nt,
                                  reverse=reverse)
    ids = ids.reshape(shape + (node.count,))
    return _Rec(ids, lookup_nodes(nt, ids, type_name=result_type))
