"""GSL query -> eager device plan.

Counterpart of ``graph_learn_tpu/gsl/compile.py`` ``Query:51``,
``source_space:69``, ``device_tables:77``, ``_execute:156``, and of the
``source_v``, ``source_e`` and ``endpoint_*`` branches of
``_exec_node:172``, ``_exec_hop:249`` (``out_v`` / ``in_v`` / ``out_e`` /
``in_e``; ``full`` returns ``SparseNodes``, on an edge hop too, as in the
JAX package), ``_exec_neg:372`` with its conditional branch
(``build_condition_tables:108``, ``_exec_conditional_neg:408``), with
``.filter()`` and registered strategies, and the ``walk`` branch
(``:215-225``: the walks of the parent's ids, -1 where a walker is stuck,
over the out-adjacency, with the dst node table's payload looked up at
``max(id, 0)``), and the ``subgraph`` branch (``:227-245``: the
subgraph induced over the edge type's out-adjacency by the parent's ids,
ops/subgraph.py, with the src node table's payload looked up at the node
ids, 0 where a slot holds the padding).  PyTorch runs eagerly, so there
is no jit: ``_execute`` walks the DAG once per call.  Each hop's feature
rows stay deferred (ops/lookup.py) until a reader gathers or reduces them.
Randomness comes from one explicit ``torch.Generator``, drawn from in DAG
order (the JAX package splits one key per node; the two streams differ,
see ops/sampling.py).

Time threads through the plan as in the JAX package (``_Rec.ts:39-48``):
an ``E()`` source over a timestamped edge type carries its events'
timestamps, its endpoint views inherit them (``:193-207``), and a hop
whose parent carries timestamps over a timestamped edge type samples only
edges strictly earlier than the parent's time (ops/temporal.py:
``full``, ``random``, ``edge_weight``, ``in_degree``,
``random_without_replacement``, ``topk``; a registered strategy must
accept ``t_upper`` or the plan raises, ``:277-343``).  The hop then
carries its sampled edges' timestamps (``hop_ts``, ``:346-368``), so a
deeper hop is bounded by the edge that led to it, and negatives inherit
the time of the row they were drawn for (``:403-405``).
"""

from __future__ import annotations

import inspect
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.values import Edges, Nodes
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.gsl.dag import Dag, DagNode
from graph_learn_tpu_torch.ops import conditional as cond_ops
from graph_learn_tpu_torch.ops import negative as neg_ops
from graph_learn_tpu_torch.ops import sampling as samp_ops
from graph_learn_tpu_torch.ops import subgraph as sg_ops
from graph_learn_tpu_torch.ops import temporal as temporal_ops
from graph_learn_tpu_torch.ops import walk as walk_ops
from graph_learn_tpu_torch.ops.lookup import (edge_field, edge_payload,
                                              lookup_nodes,
                                              lookup_sparse_nodes)
from graph_learn_tpu_torch.ops.segment import row_bounds
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device


class _Rec:
    """Per-node execution record inside the plan: the node's dense ids, its
    value (``Nodes``, ``SparseNodes`` or ``Edges``) and, on a temporal
    path, the per-element timestamps that bound the hops below it."""

    __slots__ = ("ids", "value", "ts")

    def __init__(self, ids, value, ts=None):
        self.ids = ids
        self.value = value
        self.ts = ts


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
        # {device: (weak references to the store tables they index, the
        #           condition tables of the query's .where() nodes)}
        self._cond: Dict[object, tuple] = {}

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
        """The node and edge tables the plan reads, and the condition
        tables of its ``.where()`` nodes, on ``device`` (default: the
        graph's device).  The JAX package rebuilds the condition tables on
        every call; here they are kept per device and rebuilt only when the
        store holds another node or edge table than they were built from
        (``add_node_table`` / ``add_edge_table`` replaced one), so a query
        run many times sorts its columns once."""
        device = self.graph.device if device is None else device
        dev = resolve_device(device)
        store = self.graph.store
        sources = [t for n in self.dag.nodes if n.strategy == "conditional"
                   for t in _condition_sources(store, n)]
        kept = self._cond.get(dev)
        if kept is None or [r() for r in kept[0]] != sources:
            self._cond[dev] = ([weakref.ref(t) for t in sources],
                               build_condition_tables(self, device))
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
            "cond": self._cond[dev][1],
        }

    def run(self, seeds: torch.Tensor, generator: torch.Generator):
        return _execute(self, self.device_tables(), seeds, generator)


def _condition_sources(store, n: DagNode):
    """(node table, edge table) that a ``.where()`` node's condition table
    indexes: the negatives' side of the edge type, and the edge type."""
    s_t, d_t = store.topology[n.edge_type]
    return (store.node_table(s_t if n.kind == "in_neg" else d_t),
            store.edge_table(n.edge_type))


def build_condition_tables(query: Query, device: DeviceLike) -> dict:
    """{str(dag nid): ConditionTable} for every ``.where()`` node: the str
    columns merged into the int columns (they are hashed int columns in the
    store), each node weighed by the base strategy (``in_degree``: the
    in-degree, for ``inNeg`` the out-degree; ``node_weight``: the node
    table's weights; else uniform)."""
    store = query.graph.store
    out = {}
    for n in query.dag.nodes:
        if n.strategy != "conditional":
            continue
        nt, et = _condition_sources(store, n)
        cond = n.condition or {}
        int_cols = list(cond.get("int_cols", [])) + \
            list(cond.get("str_cols", []))
        float_cols = list(cond.get("float_cols", []))
        if n.base_strategy == "in_degree":
            w = (et.out_degrees if n.kind == "in_neg"
                 else et.in_degrees).astype(np.float64)
        elif n.base_strategy == "node_weight":
            w = nt.weights
        else:
            w = None
        out[str(n.nid)] = cond_ops.ConditionTable.build(
            nt, int_cols, float_cols, w, device)
    return out


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
            type_name=node.edge_type, **pay)
        return _Rec(src_ids, val, pay["timestamps"])
    parent = recs[node.parent.nid]
    if kind in ("endpoint_src", "endpoint_dst"):
        ev = parent.value
        nv = ev.src_nodes if kind == "endpoint_src" else ev.dst_nodes
        return _Rec(nv.ids, nv, parent.ts)
    if kind in ("out_v", "in_v", "out_e", "in_e"):
        return _exec_hop(query, tables, node, parent, recs, generator)
    if kind in ("out_neg", "in_neg"):
        return _exec_neg(query, tables, node, parent, recs, generator)
    if kind == "walk":
        et = tables["edges"][node.edge_type]
        d_t = query.graph.store.topology[node.edge_type][1]
        shape = tuple(parent.ids.shape)
        walks = walk_ops.node2vec_walk(
            et.out, parent.ids.reshape(-1), node.walk_len, generator,
            p=node.walk_p, q=node.walk_q).reshape(shape + (node.walk_len,))
        val = lookup_nodes(tables["nodes"][d_t], torch.clamp(walks, min=0),
                           type_name=d_t)
        # the -1 of a stuck walker stays visible in the ids
        return _Rec(walks, val.replace(ids=walks))
    if kind == "subgraph":
        et = tables["edges"][node.edge_type]
        s_t = query.graph.store.topology[node.edge_type][0]
        sg = sg_ops.induce_subgraph(et.out, parent.ids.reshape(-1),
                                    nbr_cap=node.nbr_cap,
                                    need_dist=node.need_dist)
        nodes = lookup_nodes(
            tables["nodes"][s_t],
            torch.where(sg.node_ids < sg_ops.FILL, sg.node_ids, 0),
            type_name=s_t)
        return _Rec(sg.node_ids, sg.replace(nodes=nodes,
                                            type_name=node.edge_type))
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
    # temporal traversal: a parent that carries timestamps bounds a hop
    # over a timestamped edge type to edges strictly before its time
    # (reference auto-injected ts filters, gsl/dag_node.py:357-364)
    t_upper = None
    if parent.ts is not None and csr.nbr_ts is not None:
        t_upper = parent.ts.reshape(-1)
    if strategy == "full":
        # SparseNodes on an edge hop too, as the JAX package answers it
        cap = k if k > 0 else conf.default_full_nbr_num
        if t_upper is not None:
            ids, eids, degs = temporal_ops.temporal_full_sample(
                csr, flat, cap, t_upper, flt=flt)
        else:
            ids, eids, degs = samp_ops.full_sample(csr, flat, cap, flt=flt)
        val = lookup_sparse_nodes(nt, ids, degs, type_name=result_type)
        new_ts = (edge_field(et, "timestamps", eids).reshape(shape + (cap,))
                  if t_upper is not None else None)
        return _Rec(ids.reshape(shape + (cap,)), val, new_ts)
    if t_upper is not None:
        ids, eids = _temporal_hop(csr, flat, k, strategy, generator, t_upper,
                                  flt)
    elif strategy in ("edge_weight", "in_degree"):
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
    eids = eids.reshape(shape + (k,))
    if node.kind in ("out_v", "in_v"):
        # on a temporal path the sampled edges' times bound the next hop
        hop_ts = (edge_field(et, "timestamps", eids)
                  if t_upper is not None else None)
        return _Rec(ids, lookup_nodes(nt, ids, type_name=result_type),
                    hop_ts)
    # edge hop: Edges whose src view repeats the parent's id in every slot
    src_type = d_t if incoming else s_t
    pay = edge_payload(et, eids)
    val = Edges(
        edge_ids=eids,
        src_nodes=lookup_nodes(tables["nodes"][src_type],
                               parent.ids[..., None].expand(ids.shape),
                               type_name=src_type),
        dst_nodes=lookup_nodes(nt, ids, type_name=result_type),
        type_name=node.edge_type, **pay)
    # an edge hop carries its edges' times whenever the type has them, as
    # the JAX plan's does
    return _Rec(ids, val, pay["timestamps"])


def _temporal_hop(csr, flat, k: int, strategy: str, generator, t_upper,
                  flt):
    """(ids, eids) [b, k] of a hop bounded by ``t_upper`` [b]."""
    if strategy == "random":
        return temporal_ops.temporal_uniform_sample(csr, flat, k, generator,
                                                    t_upper, flt=flt)
    if strategy in ("edge_weight", "in_degree"):
        return temporal_ops.temporal_weighted_sample(
            csr, flat, k, generator, t_upper, by=strategy, flt=flt)
    if strategy == "random_without_replacement":
        return temporal_ops.temporal_without_replacement_sample(
            csr, flat, k, generator, t_upper, flt=flt)
    if strategy == "topk":
        return temporal_ops.temporal_topk_sample(csr, flat, k, t_upper,
                                                 flt=flt)
    if strategy in samp_ops.STRATEGY_FNS:
        # a registered strategy must take the before-t bound: no silent
        # temporal leakage
        fn = samp_ops.STRATEGY_FNS[strategy]
        if "t_upper" not in inspect.signature(fn).parameters:
            raise InvalidArgumentError(
                "custom strategy %r does not accept t_upper and the seed "
                "path is temporal; add a t_upper keyword to the registered "
                "sampler" % strategy)
        return fn(csr, flat, k, generator, t_upper=t_upper)
    raise InvalidArgumentError("unknown strategy %r" % strategy)


def _exec_neg(query: Query, tables, node: DagNode, parent: _Rec, recs,
              generator):
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
    if node.strategy == "conditional":
        ids = _exec_conditional_neg(query, tables, node, recs, flat, et, nt,
                                    generator)
    else:
        ids = neg_ops.negative_sample(et, flat, node.count, generator,
                                      strategy=node.strategy, dst_table=nt,
                                      reverse=reverse)
    ids = ids.reshape(shape + (node.count,))
    # negatives inherit the time of their row: hops below a negative tower
    # stay bounded by the event (reference TGAT train_eval.py:58-78)
    neg_ts = (parent.ts[..., None].expand(ids.shape)
              if parent.ts is not None else None)
    return _Rec(ids, lookup_nodes(nt, ids, type_name=result_type), neg_ts)


def _exec_conditional_neg(query: Query, tables, node: DagNode, recs, flat,
                          et, dst_table, generator) -> torch.Tensor:
    """``.where(target, condition)`` negatives of the seeds ``flat``: the
    positive of each row is the target's id there."""
    cond = node.condition or {}
    target = query.dag.get_node(node.filter_alias)
    pos_dst = recs[target.nid].ids.reshape(-1)
    ct = tables["cond"][str(node.nid)]
    reverse = node.kind == "in_neg"
    pool = et.unique_src if reverse else et.unique_dst
    pool_cdf = (et.unique_src_outdeg_cdf if reverse
                else et.unique_dst_indeg_cdf)
    if pool is None:
        raise InvalidArgumentError(
            "conditional negative sampling needs the candidate-pool and "
            "membership tables, which storage_profile='minimal' drops — "
            "use the default profile for queries with .where()")
    if node.base_strategy == "in_degree":
        def base_draw(gen, shape):
            return neg_ops.cdf_ids(pool, pool_cdf, shape, gen)
    elif node.base_strategy == "node_weight":
        all_ids = torch.arange(dst_table.num_nodes, dtype=torch.int32,
                               device=pool.device)

        def base_draw(gen, shape):
            return neg_ops.cdf_ids(all_ids, dst_table.cum_weights, shape,
                                   gen)
    else:
        def base_draw(gen, shape):
            return neg_ops.uniform_ids(pool, shape, gen)
    int_cols = list(cond.get("int_cols", [])) + list(cond.get("str_cols",
                                                              []))
    int_props = list(cond.get("int_props", [])) + list(
        cond.get("str_props", []))
    float_cols = list(cond.get("float_cols", []))
    # the positives' attribute rows, read only where a column asks
    pos = pos_dst.long()
    pia = (dst_table.int_attrs[pos]
           if int_cols and dst_table.int_attrs is not None else None)
    pfa = (dst_table.float_attrs[pos]
           if float_cols and dst_table.float_attrs is not None else None)
    return cond_ops.conditional_negative_sample(
        et, ct, flat, pos_dst, pia, pfa, node.count, generator,
        int_cols, int_props, float_cols, list(cond.get("float_props", [])),
        base_draw, batch_share=bool(cond.get("batch_share", False)),
        unique=bool(cond.get("unique", False)), reverse=reverse)
