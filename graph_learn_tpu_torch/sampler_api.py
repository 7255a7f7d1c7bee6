"""Sampler objects: the reference's pre-GSL request-per-call API.

Counterpart of ``graph_learn_tpu/sampler_api.py`` (``NodeSampler:43``,
``EdgeSampler:65``, ``NeighborSampler:100``, ``NegativeSampler:154``,
``SubGraphSampler:191``, ``RandomWalkSampler:218`` and the factories of
``install_factories:238``): ``s = g.neighbor_sampler(edge_type, k,
strategy); s.get(ids)``.  Each call runs the port's ops on the graph's
device (``core/traversal.py`` for the seed batches, ``ops/sampling.py``,
``ops/negative.py``, ``ops/subgraph.py``, ``ops/walk.py``,
``ops/lookup.py``) and answers the value structs GSL answers; the float
feature rows of every answer stay ``DeferredRows``, so a reader that
materialises a hop's rows makes one Kernel 1 launch on the card.

A sampler draws from one ``torch.Generator`` on the graph's device,
seeded from ``seed`` or else ``conf.seed``, where the JAX sampler splits a
key per call.  ``get(ids)`` takes raw node ids; a node sampler's ``get()``
takes none and raises ``OutOfRangeError`` at an epoch's end (not for
``random``).  Importing the package attaches the factories to ``Graph``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.schema import Mask, mask_type
from graph_learn_tpu_torch.core.traversal import Traverser
from graph_learn_tpu_torch.core.values import (Edges, Nodes, SparseNodes,
                                               SubGraphVal)
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops import negative as neg_ops
from graph_learn_tpu_torch.ops import sampling as samp_ops
from graph_learn_tpu_torch.ops import subgraph as sg_ops
from graph_learn_tpu_torch.ops import walk as walk_ops
from graph_learn_tpu_torch.ops.lookup import (edge_field, edge_payload,
                                              lookup_nodes,
                                              lookup_sparse_nodes)


def _traversal(strategy: str) -> str:
    return strategy if strategy in ("shuffle", "random") else "by_order"


class _Base:
    def __init__(self, graph, seed: Optional[int] = None):
        self.graph = graph
        self.device = graph.device
        self.seed = conf.seed if seed is None else seed
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed)

    def _node_view(self, node_type: str):
        return self.graph.store.node_table(node_type).device(self.device)

    def _indices(self, node_type: str, ids) -> torch.Tensor:
        """Raw ids -> dense int32 indices on the device (unknown ids
        raise NotFoundError)."""
        idx = self.graph.store.node_table(node_type).index.lookup(
            np.asarray(ids, np.int64))
        return torch.as_tensor(idx, device=self.device)


class NodeSampler(_Base):
    """Batches of a node set: ``by_order``, ``shuffle`` or ``random``
    (reference sampler/node_sampler.py)."""

    def __init__(self, graph, node_type: str, batch_size: int = 64,
                 strategy: str = "by_order", mask=Mask.NONE, seed=None):
        super().__init__(graph, seed)
        self.node_set = graph.store.node_set(mask_type(node_type, mask))
        self.base_type = self.node_set.base_type
        self._trav = Traverser(self.node_set.size, batch_size,
                               strategy=_traversal(strategy), seed=self.seed)

    def get(self) -> Nodes:
        pos, _ = self._trav.next()
        idx = torch.as_tensor(self.node_set.indices[pos].astype(np.int32),
                              device=self.device)
        return lookup_nodes(self._node_view(self.base_type), idx,
                            type_name=self.base_type)


class EdgeSampler(_Base):
    """Batches of an edge table's rows (reference
    sampler/edge_sampler.py)."""

    def __init__(self, graph, edge_type: str, batch_size: int = 64,
                 strategy: str = "by_order", seed=None):
        super().__init__(graph, seed)
        self.edge_type = edge_type
        self.et = graph.store.edge_table(edge_type)
        self._trav = Traverser(self.et.num_edges, batch_size,
                               strategy=_traversal(strategy), seed=self.seed)

    def get(self) -> Edges:
        pos, _ = self._trav.next()
        eidx = torch.as_tensor(pos.astype(np.int32), device=self.device)
        dev = self.et.device(self.device)
        s_t, d_t = self.et.src_type, self.et.dst_type
        src = lookup_nodes(self._node_view(s_t), edge_field(dev, "src", eidx),
                           type_name=s_t)
        dst = lookup_nodes(self._node_view(d_t), edge_field(dev, "dst", eidx),
                           type_name=d_t)
        return Edges(edge_ids=eidx, src_nodes=src, dst_nodes=dst,
                     type_name=self.edge_type, **edge_payload(dev, eidx))


class NeighborSampler(_Base):
    """Fixed-fanout neighbour sampling, one hop per fanout (reference
    sampler/neighbor_sampler.py): ``get(ids)`` takes raw node ids and
    answers one ``Nodes`` per hop, [b, k1], [b, k1, k2], ... (a
    ``SparseNodes`` per hop for ``full``, capped at the fanout or, for 0,
    ``conf.default_full_nbr_num``).  Each hop samples the edge type's
    out-CSR from the previous hop's ids, as the JAX sampler does."""

    def __init__(self, graph, edge_type: str,
                 expand_factor: Union[int, Sequence[int]],
                 strategy: str = "random", seed=None):
        super().__init__(graph, seed)
        self.edge_type = edge_type
        self.fanouts = ([expand_factor] if isinstance(expand_factor, int)
                        else list(expand_factor))
        self.strategy = strategy
        self.et = graph.store.edge_table(edge_type)

    def _hop(self, csr, flat: torch.Tensor, k: int):
        s, gen = self.strategy, self.generator
        if s == "random":
            return samp_ops.uniform_sample(csr, flat, k, gen)
        if s == "topk":
            return samp_ops.topk_sample(csr, flat, k)
        if s in ("edge_weight", "in_degree"):
            return samp_ops.weighted_sample(csr, flat, k, gen, by=s)
        if s == "random_without_replacement":
            return samp_ops.without_replacement_sample(csr, flat, k, gen)
        raise InvalidArgumentError("strategy %r" % s)

    def get(self, ids) -> List[Union[Nodes, SparseNodes]]:
        d_t = self.et.dst_type
        csr = self.et.device(self.device).out
        dst_view = self._node_view(d_t)
        cur = self._indices(self.et.src_type, ids)
        out = []
        for k in self.fanouts:
            flat = cur.reshape(-1)
            if self.strategy == "full":
                cap = k if k > 0 else conf.default_full_nbr_num
                nbr, _, degs = samp_ops.full_sample(csr, flat, cap)
                out.append(lookup_sparse_nodes(dst_view, nbr, degs,
                                               type_name=d_t))
            else:
                nbr, _ = self._hop(csr, flat, k)
                nbr = nbr.reshape(cur.shape + (k,))
                out.append(lookup_nodes(dst_view, nbr, type_name=d_t))
            cur = nbr
        return out


class NegativeSampler(_Base):
    """Negatives of raw seed ids (reference sampler/negative_sampler.py):
    over an edge type, its dst pool by ``strategy`` (``in_degree`` and
    ``node_weight`` reject true neighbours, ``ops/negative.py``); over a
    node type, that type's nodes, uniformly or by node weight."""

    def __init__(self, graph, object_type: str, expand_factor: int,
                 strategy: str = "random", seed=None):
        super().__init__(graph, seed)
        if object_type in graph.store.edges:
            self.et, self.nt = graph.store.edge_table(object_type), None
        else:
            self.et, self.nt = None, object_type
        self.k = expand_factor
        self.strategy = strategy

    def get(self, ids) -> Nodes:
        if self.nt is not None:
            view = self._node_view(self.nt)
            neg = neg_ops.negative_sample_from_nodes(
                view, len(ids), self.k, self.generator,
                strategy=self.strategy)
            return lookup_nodes(view, neg, type_name=self.nt)
        d_t = self.et.dst_type
        dst_view = self._node_view(d_t)
        neg = neg_ops.negative_sample(
            self.et.device(self.device),
            self._indices(self.et.src_type, ids), self.k, self.generator,
            strategy=self.strategy, dst_table=dst_view)
        return lookup_nodes(dst_view, neg, type_name=d_t)


class SubGraphSampler(_Base):
    """The subgraph induced by a set of raw seed ids over ``nbr_type``
    (reference sampler/subgraph_sampler.py): each seed's first ``cap``
    neighbours, ``num_nbrs[0]`` or ``conf.default_full_nbr_num``, kept
    where they are seeds too, with the node payload (a pad slot reads row
    0)."""

    def __init__(self, graph, seed_type: str, nbr_type: str,
                 num_nbrs: Sequence[int] = (0,), need_dist: bool = False,
                 seed=None):
        super().__init__(graph, seed)
        self.et = graph.store.edge_table(nbr_type)
        self.seed_type = seed_type
        self.need_dist = need_dist
        self.cap = (num_nbrs[0] if num_nbrs and num_nbrs[0] > 0
                    else conf.default_full_nbr_num)

    def get(self, ids) -> SubGraphVal:
        s_t = self.et.src_type
        sg = sg_ops.induce_subgraph(self.et.device(self.device).out,
                                    self._indices(s_t, ids),
                                    nbr_cap=self.cap,
                                    need_dist=self.need_dist)
        real = torch.where(sg.node_ids < sg_ops.FILL, sg.node_ids, 0)
        return sg.replace(nodes=lookup_nodes(self._node_view(s_t), real,
                                             type_name=s_t))


class RandomWalkSampler(_Base):
    """node2vec walks (DeepWalk where ``p == q == 1``) from raw seed ids:
    [b, walk_len] dense ids, -1 after a dead end (``ops/walk.py``)."""

    def __init__(self, graph, edge_type: str, walk_len: int,
                 p: float = 1.0, q: float = 1.0, seed=None):
        super().__init__(graph, seed)
        self.et = graph.store.edge_table(edge_type)
        self.walk_len = walk_len
        self.p, self.q = p, q

    def get(self, ids) -> torch.Tensor:
        return walk_ops.node2vec_walk(
            self.et.device(self.device).out,
            self._indices(self.et.src_type, ids), self.walk_len,
            self.generator, p=self.p, q=self.q)


def install_factories():
    """Attach ``node_sampler`` ... ``random_walk_sampler`` to ``Graph``."""
    from graph_learn_tpu_torch.graph import Graph

    def node_sampler(self, t, batch_size=64, strategy="by_order",
                     mask=Mask.NONE, seed=None):
        return NodeSampler(self, t, batch_size, strategy, mask, seed)

    def edge_sampler(self, edge_type, batch_size=64, strategy="by_order",
                     seed=None):
        return EdgeSampler(self, edge_type, batch_size, strategy, seed)

    def neighbor_sampler(self, meta_path, expand_factor, strategy="random",
                         seed=None):
        et = (meta_path[0] if isinstance(meta_path, (list, tuple))
              else meta_path)
        return NeighborSampler(self, et, expand_factor, strategy, seed)

    def negative_sampler(self, object_type, expand_factor, strategy="random",
                         seed=None):
        return NegativeSampler(self, object_type, expand_factor, strategy,
                               seed)

    def subgraph_sampler(self, seed_type, nbr_type, num_nbrs=(0,),
                         need_dist=False, seed=None):
        return SubGraphSampler(self, seed_type, nbr_type, num_nbrs,
                               need_dist, seed)

    def random_walk_sampler(self, edge_type, walk_len, p=1.0, q=1.0,
                            seed=None):
        return RandomWalkSampler(self, edge_type, walk_len, p, q, seed)

    Graph.node_sampler = node_sampler
    Graph.edge_sampler = edge_sampler
    Graph.neighbor_sampler = neighbor_sampler
    Graph.negative_sampler = negative_sampler
    Graph.subgraph_sampler = subgraph_sampler
    Graph.random_walk_sampler = random_walk_sampler


install_factories()
