"""BatchGraph: batched per-sample subgraphs with offset-rebased edge_index.

Counterpart of ``graph_learn_tpu/nn/subgraph_data.py`` ``BatchGraph:24``
(``from_subgraphs:44``, ``from_edge_star:74``, ``anchor:137``,
``readout:143``) and ``HeteroBatchGraph:168`` (``from_samples:193``,
``anchor:227``, ``readout:233``).  Per-sample subgraphs share fixed caps
(N_cap nodes, E_cap edges), so batching is a reshape: sample i's node j
is global node i * N_cap + j, and validity masks carry the raggedness.

Feature rows stay deferred: a ``BatchGraph``'s ``nodes.float_attrs`` is
one ``DeferredRows`` over all its node slots (the edge stars' four blocks
of ids concatenated first), so a reader gathers them in one Kernel 1
launch.  The readouts pool each sample's contiguous run of slots by a
reshape, so their sums need no scatter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from graph_learn_tpu_torch.core.values import (DeferredRows, Nodes,
                                              SubGraphVal, TensorStruct)
from graph_learn_tpu_torch.nn.data import materialized
from graph_learn_tpu_torch.ops.subgraph import FILL


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


def _graph_ids(b: int, n_cap: int, like: torch.Tensor) -> torch.Tensor:
    return _arange(b, like)[:, None].expand(b, n_cap).reshape(-1)


def _pool(h: torch.Tensor, mask: torch.Tensor, b: int, op: str):
    """Per-sample ``op`` over each sample's run of ``h``'s rows [b * n, d]
    where ``mask`` holds (``jax.ops.segment_*`` over the graph ids)."""
    hm = torch.where(mask[:, None], h, 0.0).reshape(b, -1, h.shape[-1])
    s = hm.sum(dim=1)
    if op == "sum":
        return s
    cnt = mask.to(h.dtype).reshape(b, -1).sum(dim=1)
    if op == "mean":
        return s / torch.clamp(cnt, min=1.0)[:, None]
    if op == "max":
        hneg = torch.where(mask[:, None], h, float("-inf"))
        m = hneg.reshape(b, -1, h.shape[-1]).amax(dim=1)
        return torch.where(torch.isfinite(m), m, 0.0)
    raise ValueError(op)


@dataclasses.dataclass
class BatchGraph(TensorStruct):
    """B per-sample subgraphs merged into one disjoint graph."""

    edge_index: torch.Tensor  # [2, B * E_cap] rebased
    node_ids: torch.Tensor  # [B * N_cap] store indices (padding -> 0)
    node_mask: torch.Tensor  # [B * N_cap] bool
    edge_mask: torch.Tensor  # [B * E_cap] bool
    graph_ids: torch.Tensor  # [B * N_cap] the sample of each node
    num_samples: int = 0
    node_cap: int = 0
    nodes: Optional[Nodes] = None  # payload of every node slot
    dist_to_src: Optional[torch.Tensor] = None  # [B * N_cap]
    dist_to_dst: Optional[torch.Tensor] = None

    @property
    def num_nodes(self) -> int:
        return self.node_ids.shape[0]

    @classmethod
    def from_subgraphs(cls, sg: SubGraphVal) -> "BatchGraph":
        """``sg``: an ``induce_batched`` SubGraphVal with a leading batch
        axis B."""
        B, N_cap = sg.node_ids.shape
        E_cap = sg.edge_index.shape[-1]
        offs = (_arange(B, sg.node_ids) * N_cap)[:, None, None]
        edge_index = (sg.edge_index + offs).transpose(0, 1).reshape(
            2, B * E_cap)
        node_mask = (_arange(N_cap, sg.node_ids)[None, :]
                     < sg.num_nodes[:, None]).reshape(-1)
        edge_mask = (_arange(E_cap, sg.node_ids)[None, :]
                     < sg.num_edges[:, None]).reshape(-1)
        node_ids = torch.where(sg.node_ids == FILL, 0,
                               sg.node_ids).reshape(-1)
        nodes = None
        if sg.nodes is not None:
            nodes = sg.nodes.map(
                lambda x: x.reshape((B * N_cap,) + tuple(x.shape[2:])))
        d2s = (sg.dist_to_src.reshape(-1) if sg.dist_to_src is not None
               else None)
        d2d = (sg.dist_to_dst.reshape(-1) if sg.dist_to_dst is not None
               else None)
        return cls(edge_index=edge_index, node_ids=node_ids,
                   node_mask=node_mask, edge_mask=edge_mask,
                   graph_ids=_graph_ids(B, N_cap, sg.node_ids),
                   num_samples=B, node_cap=N_cap, nodes=nodes,
                   dist_to_src=d2s, dist_to_dst=d2d)

    @classmethod
    def from_edge_star(cls, src, dst, src_nbrs, dst_nbrs) -> "BatchGraph":
        """Per-edge enclosing star subgraphs (reference EdgeInducer): each
        sample's node list is [src, dst, src_nbrs..., dst_nbrs...], edges
        join src and each of its neighbours and dst and each of its, both
        ways.  ``src`` / ``dst`` are Nodes [b] (a negative dst may be [b,
        1]); ``src_nbrs`` / ``dst_nbrs`` SparseNodes [b, cap] from a
        ``full`` hop (or fixed-fanout Nodes with ``mask()``)."""
        b = src.ids.shape[0]
        ks = src_nbrs.ids.shape[-1]
        kd = dst_nbrs.ids.shape[-1]
        n_cap = 2 + ks + kd
        blocks = (src.ids.reshape(b, 1), dst.ids.reshape(b, -1)[:, :1],
                  src_nbrs.ids.reshape(b, ks), dst_nbrs.ids.reshape(b, kd))
        node_ids = torch.cat(blocks, dim=1)  # [b, n_cap]
        sm = src_nbrs.mask().reshape(b, ks)
        dm = dst_nbrs.mask().reshape(b, kd)
        like = node_ids
        node_mask = torch.cat([torch.ones((b, 2), dtype=torch.bool,
                                          device=like.device), sm, dm],
                              dim=1).reshape(-1)

        # one sample's edge template: the src star then the dst star, both
        # ways
        s_cols = torch.arange(2, 2 + ks, dtype=torch.int32,
                              device=like.device)
        d_cols = torch.arange(2 + ks, n_cap, dtype=torch.int32,
                              device=like.device)
        zeros_s, zeros_d = torch.zeros_like(s_cols), torch.zeros_like(d_cols)
        rows = torch.cat([zeros_s, s_cols, zeros_d + 1, d_cols])
        cols = torch.cat([s_cols, zeros_s, d_cols, zeros_d + 1])
        offs = (_arange(b, like) * n_cap)[:, None]
        edge_index = torch.stack([(rows[None, :] + offs).reshape(-1),
                                  (cols[None, :] + offs).reshape(-1)])
        e_mask = torch.cat([sm, sm, dm, dm], dim=1).reshape(-1)

        views = (src, dst, src_nbrs, dst_nbrs)
        widths = (1, 1, ks, kd)
        nodes = Nodes(ids=node_ids.reshape(-1),
                      int_attrs=_cat_rows(views, "int_attrs", b, widths),
                      float_attrs=_cat_rows(views, "float_attrs", b, widths),
                      type_name=src.type_name)
        return cls(edge_index=edge_index, node_ids=node_ids.reshape(-1),
                   node_mask=node_mask, edge_mask=e_mask,
                   graph_ids=_graph_ids(b, n_cap, like), num_samples=b,
                   node_cap=n_cap, nodes=nodes)

    def anchor(self, h: torch.Tensor, slot: int) -> torch.Tensor:
        """Embedding of per-sample node ``slot`` (0 = src, 1 = dst) -> [B,
        d]."""
        return h.reshape(self.num_samples, self.node_cap, -1)[:, slot]

    def readout(self, h: torch.Tensor, op: str = "mean") -> torch.Tensor:
        """Per-sample pooling (sum / mean / max) of node embeddings -> [B,
        d]."""
        return _pool(h, self.node_mask, self.num_samples, op)


def _cat_rows(views, field: str, b: int, widths):
    """The four payloads' ``field`` as one [b * n_cap, ...] block in node
    slot order, or None where one lacks it.  Deferred feature rows of one
    table stay deferred: their ids are concatenated, so a reader gathers
    every slot in one launch."""
    vs = [getattr(v, field) for v in views]
    if any(v is None for v in vs):
        return None
    if all(isinstance(v, DeferredRows) for v in vs) and all(
            v.table is vs[0].table for v in vs):
        idx = torch.cat([v.idx.reshape(b, w) for v, w in zip(vs, widths)],
                        dim=1)
        return DeferredRows(table=vs[0].table, idx=idx.reshape(-1))
    rows = [materialized(view).float_attrs if field == "float_attrs"
            else getattr(view, field) for view in views]
    d = rows[0].shape[-1]
    return torch.cat([r.reshape(b, w, d) for r, w in zip(rows, widths)],
                     dim=1).reshape(-1, d)


@dataclasses.dataclass
class HeteroBatchGraph(TensorStruct):
    """B per-sample typed subgraphs merged into disjoint typed graphs: node
    type t has N_cap[t] slots a sample, so sample i's local node j of type
    t is global slot i * N_cap[t] + j, and each edge type's edge_index is
    rebased into its src and dst types' slot spaces.  Feeds
    ``nn.layers.sub.HeteroConv``."""

    edge_index: Dict[str, torch.Tensor]  # et -> [2, B * E_cap_et]
    edge_mask: Dict[str, torch.Tensor]  # et -> [B * E_cap_et] bool
    nodes: Dict[str, Nodes]  # t -> payload of all slots [B * N_cap_t]
    node_mask: Dict[str, torch.Tensor]  # t -> [B * N_cap_t] bool
    graph_ids: Dict[str, torch.Tensor]  # t -> [B * N_cap_t]
    num_samples: int = 0
    node_cap: Dict[str, int] = dataclasses.field(default_factory=dict)
    topology: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_samples(cls, nodes_dict, node_masks, edge_index_dict,
                     edge_masks, topology) -> "HeteroBatchGraph":
        """``nodes_dict[t]``: Nodes of [B, N_cap_t, ...]; ``node_masks[t]``:
        [B, N_cap_t] bool; ``edge_index_dict[et]``: [B, 2, E_cap] local
        indices (row 0 into the src type's slots, row 1 the dst type's);
        ``edge_masks[et]`` [B, E_cap]; ``topology[et] = (src_type,
        dst_type)``."""
        b = next(iter(node_masks.values())).shape[0]
        caps = {t: m.shape[1] for t, m in node_masks.items()}
        nodes, nmask, gids = {}, {}, {}
        for t, nv in nodes_dict.items():
            n_cap = caps[t]
            nodes[t] = nv.map(
                lambda x: x.reshape((b * n_cap,) + tuple(x.shape[2:])))
            nmask[t] = node_masks[t].reshape(-1)
            gids[t] = _graph_ids(b, n_cap, node_masks[t])
        ei, em = {}, {}
        for et, local in edge_index_dict.items():
            s_t, d_t = topology[et]
            ar = _arange(b, local)[:, None]
            ei[et] = torch.stack([(local[:, 0, :] + ar * caps[s_t])
                                  .reshape(-1),
                                  (local[:, 1, :] + ar * caps[d_t])
                                  .reshape(-1)])
            em[et] = edge_masks[et].reshape(-1)
        return cls(edge_index=ei, edge_mask=em, nodes=nodes,
                   node_mask=nmask, graph_ids=gids, num_samples=b,
                   node_cap=dict(caps), topology=dict(topology))

    def anchor(self, h: torch.Tensor, node_type: str,
               slot: int) -> torch.Tensor:
        """Embedding of per-sample slot ``slot`` of a type -> [B, d]."""
        return h.reshape(self.num_samples, self.node_cap[node_type],
                         -1)[:, slot]

    def readout(self, h: torch.Tensor, node_type: str,
                op: str = "mean") -> torch.Tensor:
        """Per-sample pooling of one type's node embeddings -> [B, d]: the
        sum for ``op="sum"``, else the mean, as the JAX method."""
        return _pool(h, self.node_mask[node_type], self.num_samples,
                     "sum" if op == "sum" else "mean")
