"""GSL query builder: the fluent traversal DAG.

Counterpart of ``graph_learn_tpu/gsl/dag.py`` for the kinds the port
runs: ``g.V(t).batch(b).shuffle().alias('src').outV(e).sample(k)
.by('random').alias('hop1')...values(func)``, with ``inV`` beside ``outV``
and the strategies ``random``, ``topk``, ``edge_weight``, ``in_degree``,
``random_without_replacement`` and ``full``.  Other hops (edges, negatives,
walks, subgraphs), filters and registered strategies are not yet ported
and raise when the query is built.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

from graph_learn_tpu_torch.errors import InvalidArgumentError

_PORTED_SAMPLERS = ("random", "topk", "edge_weight", "in_degree",
                    "random_without_replacement", "full")
_HOPS = ("out_v", "in_v")


class Dag:
    def __init__(self, graph):
        self.graph = graph
        self.nodes: List["DagNode"] = []
        self.batch_size: int = 64
        self._alias: Dict[str, DagNode] = {}
        self._counter = itertools.count()

    def add(self, node: "DagNode"):
        node.nid = next(self._counter)
        self.nodes.append(node)

    def register_alias(self, alias: str, node: "DagNode"):
        if alias in self._alias:
            raise InvalidArgumentError("duplicate alias %r" % alias)
        self._alias[alias] = node

    def get_node(self, alias: str) -> "DagNode":
        if alias not in self._alias:
            raise InvalidArgumentError("unknown alias %r" % alias)
        return self._alias[alias]

    @property
    def aliased_nodes(self) -> Dict[str, "DagNode"]:
        return dict(self._alias)


class DagNode:
    """One traversal step (``source_v`` | ``out_v`` | ``in_v``)."""

    def __init__(self, dag: Dag, kind: str, parent: Optional["DagNode"],
                 edge_type: Optional[str] = None,
                 node_type: Optional[str] = None):
        self.dag = dag
        self.kind = kind
        self.parent = parent
        self.edge_type = edge_type
        self.node_type = node_type
        self.nid = -1
        self.alias_name: Optional[str] = None
        self.count = 0  # sample fanout
        self.strategy = "by_order" if kind == "source_v" else "random"
        dag.add(self)

    def alias(self, name: str) -> "DagNode":
        self.alias_name = name
        self.dag.register_alias(name, self)
        return self

    def batch(self, batch_size: int) -> "DagNode":
        if self.kind != "source_v":
            raise InvalidArgumentError(".batch() only on V() sources")
        self.dag.batch_size = int(batch_size)
        self.strategy = "by_order"
        return self

    def shuffle(self, traverse: bool = False) -> "DagNode":
        """Seeds in random order: one permutation per epoch with
        ``traverse``, else uniform with replacement (an endless epoch)."""
        if self.kind != "source_v":
            raise InvalidArgumentError(".shuffle() only on V() sources")
        self.strategy = "shuffle" if traverse else "random"
        return self

    def sample(self, count: int) -> "DagNode":
        if self.kind not in _HOPS:
            raise InvalidArgumentError(".sample() only after a hop")
        self.count = int(count)
        return self

    def by(self, strategy: str) -> "DagNode":
        if self.kind not in _HOPS:
            raise InvalidArgumentError(".by() only after .sample()")
        if strategy not in _PORTED_SAMPLERS:
            raise InvalidArgumentError(
                "sampler strategy %r is not yet ported (ported: %r)"
                % (strategy, _PORTED_SAMPLERS))
        self.strategy = strategy
        return self

    def values(self, func=None):
        """Finish the query; ``func`` post-processes each batch that
        ``Dataset.next()`` returns."""
        from graph_learn_tpu_torch.gsl.compile import Query
        return Query(self.dag, post_func=func)

    def outV(self, edge_type: str) -> "DagNode":
        return DagNode(self.dag, "out_v", self, edge_type=edge_type)

    def inV(self, edge_type: str) -> "DagNode":
        return DagNode(self.dag, "in_v", self, edge_type=edge_type)

    def filter(self, target: str) -> "DagNode":
        raise InvalidArgumentError(".filter() is not yet ported")
