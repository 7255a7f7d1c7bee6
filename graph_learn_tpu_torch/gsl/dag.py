"""GSL query builder: the fluent traversal DAG.

Counterpart of ``graph_learn_tpu/gsl/dag.py`` for the kinds the port
runs: ``g.V(t).batch(b).shuffle().alias('src').outV(e).sample(k)
.by('random').filter('src').alias('hop1')...values(func)`` and
``g.E(e).batch(b)`` with its ``outV()`` / ``inV()`` endpoint views; the
hops ``outV`` / ``inV`` / ``outE`` / ``inE`` with the strategies
``random``, ``topk``, ``edge_weight``, ``in_degree``,
``random_without_replacement`` and ``full`` and any strategy added by
``ops.sampling.register_sampler``; the negatives ``outNeg`` / ``inNeg`` /
``Neg`` with ``random``, ``in_degree``, ``soft_in_degree`` and
``node_weight``, and conditional negatives through ``.where(target,
condition)`` (``.by("conditional")``, ops/conditional.py);
``.random_walk(walk_len, p, q, edge_type)``; ``.SubGraph(edge_type,
nbr_cap, need_dist)`` (the subgraph induced by the parent's ids,
ops/subgraph.py); and ``.each()``.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional

from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops.negative import NEGATIVE_STRATEGIES
from graph_learn_tpu_torch.ops.sampling import (BUILTIN_STRATEGIES,
                                                STRATEGY_FNS)

_SOURCES = ("source_v", "source_e")
_HOPS = ("out_v", "in_v", "out_e", "in_e")
_NEGS = ("out_neg", "in_neg")
_VALID_NEG = NEGATIVE_STRATEGIES + ("conditional",)


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
    """One traversal step: ``source_v`` | ``source_e`` | ``endpoint_src`` |
    ``endpoint_dst`` | ``out_v`` | ``in_v`` | ``out_e`` | ``in_e`` |
    ``out_neg`` | ``in_neg`` | ``walk`` | ``subgraph``.  Every attribute that
    ``gsl/plan.py`` records is set here, as in the JAX package."""

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
        self.strategy = "by_order" if kind in _SOURCES else "random"
        self.base_strategy = "random"  # the unconditioned draw of .where()
        self.filter_alias: Optional[str] = None
        self.condition: Optional[dict] = None
        self.walk_len = 0
        self.walk_p = 1.0
        self.walk_q = 1.0
        self.nbr_cap: Optional[int] = None  # subgraph neighbour cap
        self.need_dist = False
        dag.add(self)

    def alias(self, name: str) -> "DagNode":
        self.alias_name = name
        self.dag.register_alias(name, self)
        return self

    def batch(self, batch_size: int) -> "DagNode":
        if self.kind not in _SOURCES:
            raise InvalidArgumentError(".batch() only on V()/E() sources")
        self.dag.batch_size = int(batch_size)
        self.strategy = "by_order"
        return self

    def shuffle(self, traverse: bool = False) -> "DagNode":
        """Seeds in random order: one permutation per epoch with
        ``traverse``, else uniform with replacement (an endless epoch)."""
        if self.kind not in _SOURCES:
            raise InvalidArgumentError(".shuffle() only on V()/E() sources")
        self.strategy = "shuffle" if traverse else "random"
        return self

    def sample(self, count: int) -> "DagNode":
        if self.kind not in _HOPS + _NEGS:
            raise InvalidArgumentError(".sample() only after a hop")
        self.count = int(count)
        return self

    def by(self, strategy: str) -> "DagNode":
        if self.kind in _NEGS:
            if strategy not in _VALID_NEG:
                raise InvalidArgumentError(
                    "negative strategy %r not in %r" % (strategy, _VALID_NEG))
            self.strategy = strategy
            return self
        if self.kind not in _HOPS:
            raise InvalidArgumentError(".by() only after .sample()")
        if strategy not in STRATEGY_FNS:
            raise InvalidArgumentError(
                "sampler strategy %r is neither one of %r nor registered "
                "(ops.sampling.register_sampler)"
                % (strategy, BUILTIN_STRATEGIES))
        self.strategy = strategy
        return self

    def each(self, func: Callable[["DagNode"], object]) -> "DagNode":
        """Branch the query: ``func(self)`` adds hops from this node."""
        func(self)
        return self

    def values(self, func=None):
        """Finish the query; ``func`` post-processes each batch that
        ``Dataset.next()`` returns."""
        from graph_learn_tpu_torch.gsl.compile import Query
        return Query(self.dag, post_func=func)

    def _hop(self, kind: str, edge_type: Optional[str]) -> "DagNode":
        if edge_type is None:
            if (self.kind in ("source_e", "out_e", "in_e")
                    and kind in ("out_v", "in_v")):
                # outV()/inV() of an edge node: its src/dst endpoints
                return EndpointNode(self.dag, kind, self)
            raise InvalidArgumentError("edge_type required")
        return DagNode(self.dag, kind, self, edge_type=edge_type)

    def outV(self, edge_type: Optional[str] = None) -> "DagNode":
        return self._hop("out_v", edge_type)

    def inV(self, edge_type: Optional[str] = None) -> "DagNode":
        return self._hop("in_v", edge_type)

    def outE(self, edge_type: str) -> "DagNode":
        return self._hop("out_e", edge_type)

    def inE(self, edge_type: str) -> "DagNode":
        return self._hop("in_e", edge_type)

    def outNeg(self, edge_type: str) -> "DagNode":
        return DagNode(self.dag, "out_neg", self, edge_type=edge_type)

    def inNeg(self, edge_type: str) -> "DagNode":
        return DagNode(self.dag, "in_neg", self, edge_type=edge_type)

    def Neg(self, node_type: str) -> "DagNode":
        """Negatives from a node set, whatever the topology."""
        return DagNode(self.dag, "out_neg", self, node_type=node_type)

    _WHERE_KEYS = ("batch_share", "unique", "int_cols", "int_props",
                   "float_cols", "float_props", "str_cols", "str_props")

    def where(self, target, condition: Optional[dict] = None) -> "DagNode":
        """Conditional negatives (reference dag_node.py:233): the strategy
        set by ``.by()`` becomes the base (unconditioned) draw; the quotas
        come from ``condition``'s int_cols / int_props, float_cols /
        float_props and str_cols / str_props (str columns are the hashed
        int columns), ``batch_share`` / ``unique`` set the rejection; the
        positive of each row is ``target``'s id."""
        for kk in (condition or {}):
            if kk not in self._WHERE_KEYS:
                raise InvalidArgumentError(
                    "condition %r is not supported." % kk)
        self.filter_alias = (target if isinstance(target, str)
                             else target.alias_name)
        self.condition = dict(condition or {})
        self.base_strategy = self.strategy
        self.strategy = "conditional"
        return self

    def random_walk(self, walk_len: int, p: float = 1.0, q: float = 1.0,
                    edge_type: Optional[str] = None) -> "DagNode":
        """[..., walk_len] walks over ``edge_type`` (default: this node's)
        from each of this node's ids: uniform, or node2vec-biased by the
        return parameter ``p`` and the in-out parameter ``q``."""
        n = DagNode(self.dag, "walk", self,
                    edge_type=edge_type or self.edge_type)
        n.walk_len = int(walk_len)
        n.walk_p, n.walk_q = float(p), float(q)
        return n

    def SubGraph(self, edge_type: str, nbr_cap: Optional[int] = None,
                 need_dist: bool = False) -> "DagNode":
        """The subgraph induced over ``edge_type`` by this node's ids: each
        seed's first ``nbr_cap`` neighbours (default
        ``conf.default_full_nbr_num``) that are also seeds; with
        ``need_dist`` the BFS distances to local nodes 0 and 1."""
        n = DagNode(self.dag, "subgraph", self, edge_type=edge_type)
        n.nbr_cap = nbr_cap
        n.need_dist = need_dist
        return n

    def filter(self, target) -> "DagNode":
        """Reject samples equal to the ids of ``target`` (an alias or a
        node) in the same row (reference dag_node.py:212)."""
        if self.kind not in _HOPS:
            raise InvalidArgumentError(".filter() only after a hop")
        self.filter_alias = (target if isinstance(target, str)
                             else target.alias_name)
        return self


class EndpointNode(DagNode):
    """The src (``outV()``) or dst (``inV()``) endpoint view of an edge
    node."""

    def __init__(self, dag: Dag, kind: str, parent: DagNode):
        super().__init__(dag, "endpoint_" + ("src" if kind == "out_v"
                                             else "dst"),
                         parent, edge_type=parent.edge_type)
