"""Model-facing data structures: ``EgoGraph`` and deferred deepest hops.

Counterpart of ``graph_learn_tpu/nn/data.py:25-135``: ``DeferredRows``
(a feature table + hop indices, reduced straight from the table by
Kernel 2; defined in core/values.py, where lookups make it),
``PreAggregatedRows`` (the reduction already done), ``pre_aggregate_hop``
and ``EgoGraph.from_query_result``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from graph_learn_tpu_torch.core.values import (DeferredRows, Nodes,
                                              TensorStruct)
from graph_learn_tpu_torch.ops.aggregate import gather_group_agg

__all__ = ["DeferredRows", "EgoGraph", "PreAggregatedRows",
           "pre_aggregate_hop"]


@dataclasses.dataclass
class PreAggregatedRows(TensorStruct):
    """Deepest-hop features already reduced over the fanout axis."""

    agg: torch.Tensor  # [n_groups, D]
    op: str = "mean"


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
            elif isinstance(v.float_attrs, DeferredRows):
                values[i] = v.replace(float_attrs=v.float_attrs.materialize())
        return cls(src=values[0], hops=values[1:], nbr_nums=nbr_nums)
