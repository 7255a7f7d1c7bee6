"""Model-facing data structures: ``EgoGraph``, ``TemporalGraph`` and
deferred deepest hops.

Counterpart of ``graph_learn_tpu/nn/data.py:25-204``: ``DeferredRows``
(a feature table + hop indices, reduced straight from the table by
Kernel 2; defined in core/values.py, where lookups make it),
``PreAggregatedRows`` (the reduction already done), ``pre_aggregate_hop``,
``EgoGraph.from_query_result`` and ``TemporalGraph.from_query_result``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from graph_learn_tpu_torch.core.values import (DeferredRows, Edges, Nodes,
                                              TensorStruct)
from graph_learn_tpu_torch.ops.aggregate import gather_group_agg

__all__ = ["DeferredRows", "EgoGraph", "PreAggregatedRows", "TemporalGraph",
           "materialized", "pre_aggregate_hop"]


@dataclasses.dataclass
class PreAggregatedRows(TensorStruct):
    """Deepest-hop features already reduced over the fanout axis."""

    agg: torch.Tensor  # [n_groups, D]
    op: str = "mean"


def materialized(v):
    """``v`` (``Nodes`` or ``Edges``) with its feature rows gathered
    (Kernel 1 on the card) where they are deferred."""
    if isinstance(v.float_attrs, DeferredRows):
        return v.replace(float_attrs=v.float_attrs.materialize())
    return v


def pre_aggregate_hop(batch: dict, alias: str, table: torch.Tensor,
                      op: str = "mean") -> dict:
    """A new {alias: value} batch whose ``alias`` hop carries
    :class:`PreAggregatedRows` instead of per-neighbour features."""
    nodes = batch[alias]
    agg = gather_group_agg(table, nodes.ids, op=op)
    return {**batch,
            alias: nodes.replace(float_attrs=PreAggregatedRows(agg, op))}


@dataclasses.dataclass
class EgoGraph(TensorStruct):
    """src + K hops of neighbour Nodes; hops[i].ids is [b, k1, ..., k_{i+1}]."""

    src: Nodes
    hops: List[Nodes] = dataclasses.field(default_factory=list)
    nbr_nums: Tuple[int, ...] = ()

    @property
    def batch_size(self) -> int:
        return self.src.ids.shape[0]

    def hop_node(self, i: int) -> Nodes:
        return self.hops[i]

    @classmethod
    def from_query_result(cls, result: dict, src_alias: str,
                          hop_aliases: Sequence[str],
                          defer_last_table=None) -> "EgoGraph":
        """Build from a plan result, gathering the feature rows the model
        reads.  With ``defer_last_table`` (the deepest hop's [N, D] device
        feature table) the deepest hop carries a :class:`DeferredRows`
        instead, which EgoGNN reduces straight from the table, so its rows
        are never gathered."""
        values = [result[src_alias]] + [result[a] for a in hop_aliases]
        nbr_nums = tuple(h.ids.shape[-1] for h in values[1:])
        defer = defer_last_table is not None and len(values) > 1
        for i, v in enumerate(values):
            if defer and i == len(values) - 1:
                values[i] = v.replace(float_attrs=DeferredRows(
                    table=defer_last_table, idx=v.ids))
            else:
                values[i] = materialized(v)
        return cls(src=values[0], hops=values[1:], nbr_nums=nbr_nums)


@dataclasses.dataclass
class TemporalGraph(TensorStruct):
    """An ego graph over a temporal event stream: ``src`` nodes at the
    event, and per hop the neighbour nodes, the edges that led to them and
    the time spans ``event_ts - edge_ts`` (f32; the store's rebase cancels
    in the difference).  ``src_t`` is zeros: the src is at the event's
    time.  Counterpart of ``graph_learn_tpu/nn/data.py:139-204``."""

    src: Nodes
    src_t: torch.Tensor  # [b] f32
    nbr_nodes: List[Nodes] = dataclasses.field(default_factory=list)
    nbr_t: List[torch.Tensor] = dataclasses.field(default_factory=list)
    nbr_edges: List[Edges] = dataclasses.field(default_factory=list)
    nbr_nums: Tuple[int, ...] = ()

    @property
    def batch_size(self) -> int:
        return self.src.ids.shape[0]

    def hop_node(self, i: int) -> Nodes:
        return self.nbr_nodes[i]

    def hop_edge(self, i: int) -> Edges:
        return self.nbr_edges[i]

    def hop_t(self, i: int) -> torch.Tensor:
        return self.nbr_t[i]

    @classmethod
    def from_query_result(cls, result: dict, src_alias: str,
                          edge_aliases: Sequence[str],
                          node_aliases: Sequence[str],
                          event_alias: str) -> "TemporalGraph":
        """Build from the result of a ``g.E(<timestamped type>)`` event
        query: ``edge_aliases[i]`` is hop i's ``outE(...)`` alias (Edges
        with timestamps), ``node_aliases[i]`` its ``.inV()`` alias.  Every
        node and edge feature row the model reads is gathered (Kernel 1 on
        the card)."""
        if len(edge_aliases) != len(node_aliases):
            raise ValueError("%d edge aliases for %d node aliases"
                             % (len(edge_aliases), len(node_aliases)))
        event_ts = result[event_alias].timestamps
        if event_ts is None:
            raise ValueError(
                "TemporalGraph needs a timestamped event root (g.E on a "
                "temporal edge type)")
        src = materialized(result[src_alias])
        b = event_ts.shape[0]
        src_t = torch.zeros(src.ids.shape[0], dtype=torch.float32,
                            device=event_ts.device)
        nbr_nodes, nbr_t, nbr_edges = [], [], []
        for ea, na in zip(edge_aliases, node_aliases):
            ev = materialized(result[ea])
            nbr_edges.append(ev)
            nbr_nodes.append(materialized(result[na]))
            # the span to the EVENT's time, over the whole hop tree
            ts = ev.timestamps
            shape = (b,) + (1,) * (ts.dim() - 1)
            nbr_t.append(event_ts.reshape(shape).to(torch.float32)
                         - ts.to(torch.float32))
        return cls(src=src, src_t=src_t, nbr_nodes=nbr_nodes, nbr_t=nbr_t,
                   nbr_edges=nbr_edges,
                   nbr_nums=tuple(v.ids.shape[-1] for v in nbr_nodes))
