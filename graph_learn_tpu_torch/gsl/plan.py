"""GSL query plans as JSON-safe records: ``query_to_plan`` and
``plan_to_query``.

A port of ``graph_learn_tpu/gsl/plan.py:24-75``: one record per DAG node
with its kind, types, fanout, strategies, alias, filter or ``.where()``
target and condition, walk settings, SubGraph settings and its parent's
id, so that a client installs a query without sharing Python objects.
The records are the JAX package's, field for field: a plan made by either
package installs in the other.  A condition key that ``.where()`` would
refuse is refused here too.
"""

from __future__ import annotations

from typing import Dict, List

from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.gsl.dag import Dag, DagNode, EndpointNode

_FIELDS = ("kind", "edge_type", "node_type", "alias_name", "count",
           "strategy", "base_strategy", "filter_alias", "condition",
           "walk_len", "walk_p", "walk_q", "nbr_cap", "need_dist")


def query_to_plan(query) -> dict:
    """A built query's DAG as a JSON-safe plan dict."""
    dag = query.dag
    nodes: List[dict] = []
    for n in dag.nodes:
        rec = {f: getattr(n, f) for f in _FIELDS}
        rec["nid"] = n.nid
        rec["parent"] = n.parent.nid if n.parent is not None else None
        rec["endpoint"] = isinstance(n, EndpointNode)
        nodes.append(rec)
    return {"batch_size": dag.batch_size, "nodes": nodes}


def plan_to_query(graph, plan: dict):
    """An executable query over ``graph`` from a plan dict."""
    dag = Dag(graph)
    dag.batch_size = int(plan.get("batch_size", 64))
    by_nid: Dict[int, DagNode] = {}
    for rec in sorted(plan["nodes"], key=lambda r: r["nid"]):
        parent = (by_nid.get(rec["parent"]) if rec["parent"] is not None
                  else None)
        if rec["parent"] is not None and parent is None:
            raise InvalidArgumentError(
                "plan node %r references unknown parent %r"
                % (rec["nid"], rec["parent"]))
        if rec.get("endpoint"):
            kind = "out_v" if rec["kind"] == "endpoint_src" else "in_v"
            node = EndpointNode(dag, kind, parent)
        else:
            node = DagNode(dag, rec["kind"], parent,
                           edge_type=rec["edge_type"],
                           node_type=rec["node_type"])
        for f in _FIELDS:
            if f == "kind" or (rec.get("endpoint") and f == "edge_type"):
                continue
            if f in rec and rec[f] is not None:
                setattr(node, f, rec[f])
        for kk in node.condition or {}:
            if kk not in DagNode._WHERE_KEYS:
                raise InvalidArgumentError(
                    "condition %r is not supported." % kk)
        if node.alias_name:
            dag.register_alias(node.alias_name, node)
        by_nid[rec["nid"]] = node
    if not dag.nodes or dag.nodes[0].kind not in ("source_v", "source_e"):
        raise InvalidArgumentError("plan must start at a V()/E() source")
    from graph_learn_tpu_torch.gsl.compile import Query
    return Query(dag)
