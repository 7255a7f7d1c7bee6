"""GSL entry points ``g.V(...)`` and ``g.E(...)``.

Counterpart of ``graph_learn_tpu/gsl/query.py`` ``v_entry:15`` and
``e_entry:51``: a node type, a masked split of one (``mask``), or the
distinct src / dst nodes of an edge type (``node_from``) as the seed set
of ``V()``; an edge type's rows as the seed space of ``E()``.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from graph_learn_tpu_torch.core.schema import Mask, NodeFrom, mask_type
from graph_learn_tpu_torch.core.store import NodeSet
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.gsl.dag import Dag, DagNode


def v_entry(graph, t: str, node_from=None,
            mask: Union[Mask, str, None] = Mask.NONE) -> DagNode:
    if isinstance(mask, str):
        mask = Mask[mask.upper()]
    mask = mask or Mask.NONE
    if isinstance(node_from, str):
        node_from = NodeFrom[node_from.upper()]
    if node_from in (NodeFrom.EDGE_SRC, NodeFrom.EDGE_DST):
        # t is an edge type; the seed set is its distinct src / dst nodes
        if mask != Mask.NONE:
            raise InvalidArgumentError(
                "mask is only valid with node_from=NODE")
        et = graph.store.edge_table(t)
        is_src = node_from == NodeFrom.EDGE_SRC
        typed = ("ESRC*" if is_src else "EDST*") + t
        if typed not in graph.store.node_sets:
            col = et.src if is_src else et.dst
            graph.store.add_node_set(NodeSet(
                type_name=typed,
                base_type=et.src_type if is_src else et.dst_type,
                indices=np.unique(col).astype(np.int32)))
    else:
        typed = mask_type(t, mask)
    graph.store.node_set(typed)  # validate early
    return DagNode(Dag(graph), "source_v", None, node_type=typed)


def e_entry(graph, edge_type: str) -> DagNode:
    graph.store.edge_table(edge_type)  # validate early
    return DagNode(Dag(graph), "source_e", None, edge_type=edge_type)
