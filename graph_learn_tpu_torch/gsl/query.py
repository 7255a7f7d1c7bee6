"""GSL entry point ``g.V(...)``.

Counterpart of ``graph_learn_tpu/gsl/query.py`` ``v_entry`` for plain node
types (no masks, no edge-endpoint seed spaces yet).
"""

from __future__ import annotations

from graph_learn_tpu_torch.gsl.dag import Dag, DagNode


def v_entry(graph, t: str) -> DagNode:
    graph.store.node_set(t)  # validate early
    return DagNode(Dag(graph), "source_v", None, node_type=t)
